"""Oracles for the port's kernels (counterpart of ``repro/kernels/ref.py``).

The reference's pure-jnp oracle ``dpxor_ref`` is, in the port, the plain
PyTorch version that sits beside the CUDA kernel; this module names it
under the reference's name so tests and readers find it either way.
"""
from repro_torch.kernels.dpxor import dpxor_plain as dpxor_ref
from repro_torch.kernels.fused_scan import (
    fused_scan_xor_plain as fused_scan_xor_ref)

__all__ = ["dpxor_ref", "fused_scan_xor_ref"]
