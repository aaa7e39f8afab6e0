"""``python -m repro_torch.engine`` — the tuner's CLI (``tuner.main``).

A package entry point (not ``-m repro_torch.engine.tuner``), so runpy does
not import the tuner module twice through the package's re-exports.
"""
from repro_torch.engine.tuner import main

if __name__ == "__main__":
    raise SystemExit(main())
