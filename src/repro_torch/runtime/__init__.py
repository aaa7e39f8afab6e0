"""The port's serving runtime (``serve_loop.py``)."""
