"""The port's serving runtime (``serve_loop.py``) and its train half's
steps and loop (``steps.py``, ``train_loop.py``)."""
