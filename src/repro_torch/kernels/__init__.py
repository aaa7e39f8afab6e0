"""The port's kernels: CUDA C++ sources in ``csrc/``, their ops, and their
plain PyTorch versions (``ops.py`` is the public entry)."""
