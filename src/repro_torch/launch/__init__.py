"""Device groups of the port (``launch/mesh.py``) and the training
launcher (``launch/train.py``)."""
