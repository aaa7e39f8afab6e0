"""Oracles for the port's kernels (counterpart of ``repro/kernels/ref.py``).

The reference's pure-jnp oracles (``dpxor_ref``, ``ggm_expand_ref``,
``pir_matmul_ref``) are, in the port, the plain PyTorch versions that sit
beside the CUDA kernels; this module names them under the reference's
names so tests and readers find them either way.
"""
from repro_torch.kernels.dpxor import dpxor_plain as dpxor_ref
from repro_torch.kernels.fused_scan import (
    fused_scan_add_plain as fused_scan_add_ref,
    fused_scan_xor_plain as fused_scan_xor_ref)
from repro_torch.kernels.ggm_expand import ggm_expand_plain as ggm_expand_ref
from repro_torch.kernels.pir_matmul import pir_gemm_plain as pir_matmul_ref

__all__ = ["dpxor_ref", "fused_scan_add_ref", "fused_scan_xor_ref",
           "ggm_expand_ref", "pir_matmul_ref"]
