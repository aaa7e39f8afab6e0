"""Device groups of the port (``launch/mesh.py``)."""
