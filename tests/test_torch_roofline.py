"""The port's roofline module (``repro_torch/analysis/roofline.py``)
against the reference's (``repro/analysis/roofline.py``).

The pure functions are held equal on the same inputs; the three-term
model is held to the reference's terms scaled by the ratio of the two
chips' constants (the TPU v5e's against the H100's data sheet); the six
kernels' bounds moved out of ``chip_smoke.py`` are held at the shapes
PERF.md §6 reports them for.
"""
import math

import pytest

from repro.analysis import roofline as ref
from repro_torch.analysis import roofline as rl

SHAPES = [("bf16", "4,128,256"), ("f32", ""), ("s8", "3"), ("pred", "7,9"),
          ("u32", "1024,8"), ("f8e4m3fn", "16"), ("c128", "2,2"),
          ("tuple", "5")]


@pytest.mark.parametrize("dtype,dims", SHAPES)
def test_shape_bytes_equals_the_reference(dtype, dims):
    assert rl.shape_bytes(dtype, dims) == ref.shape_bytes(dtype, dims)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int32",
                                   "int64", "uint8", "float16", "bool"])
def test_tensor_bytes_is_the_torch_twin(dtype):
    import torch
    dt = getattr(torch, dtype)
    shape = (3, 5, 7)
    assert rl.tensor_bytes(dt, shape) == torch.empty(
        shape, dtype=dt).nbytes
    hlo = {"bfloat16": "bf16", "float32": "f32", "int8": "s8",
           "int32": "s32", "int64": "s64", "uint8": "u8", "float16": "f16",
           "bool": "pred"}[dtype]
    assert rl.tensor_bytes(dt, shape) == ref.shape_bytes(hlo, "3,5,7")


@pytest.mark.parametrize("cost", [
    {"flops": 3.0, "bytes accessed": 10.0},
    [{"flops": 1.0, "bytes accessed": 2.0}, {"flops": 4.0, "x": 1.0}],
    []])
def test_cost_totals_equals_the_reference(cost):
    assert rl.cost_totals(cost) == ref.cost_totals(cost)


@pytest.mark.parametrize("n,d,training", [(10, 5, True), (10, 5, False),
                                          (2_634_000_000, 16_384, True),
                                          (7, 0, False)])
def test_model_flops_for_equals_the_reference(n, d, training):
    assert rl.model_flops_for(n, d, training=training) == \
        ref.model_flops_for(n, d, training=training)


def _pair(**kw):
    return ref.Roofline(**kw), rl.Roofline(**kw)


@pytest.mark.parametrize("kw", [
    dict(name="x", n_chips=256, hlo_flops=256 * 197e12,
         hlo_bytes=256 * 819e9 * 2, collective_bytes=256 * 50e9 * 0.5,
         model_flops=0.5 * 256 * 197e12),
    dict(name="one", n_chips=1, hlo_flops=4e14, hlo_bytes=2e13,
         collective_bytes=0.0, model_flops=2.6e14, hlo_elem_flops=5e12),
    dict(name="coll", n_chips=4, hlo_flops=1e12, hlo_bytes=1e9,
         collective_bytes=9e12, model_flops=0.0),
])
def test_roofline_terms_scale_with_the_chips_constants(kw):
    a, b = _pair(**kw)
    assert math.isclose(b.t_compute, a.t_compute * ref.PEAK_FLOPS
                        / rl.PEAK_FLOPS, rel_tol=1e-12)
    assert math.isclose(b.t_memory, a.t_memory * ref.HBM_BW / rl.HBM_BW,
                        rel_tol=1e-12)
    assert math.isclose(b.t_collective, a.t_collective * ref.LINK_BW
                        / rl.LINK_BW, rel_tol=1e-12)
    terms = {"compute": b.t_compute, "memory": b.t_memory,
             "collective": b.t_collective}
    assert b.bottleneck == max(terms, key=terms.get)
    assert b.step_time == max(terms.values())
    assert b.useful_flop_ratio == a.useful_flop_ratio
    if b.step_time:
        assert math.isclose(b.mfu, kw["model_flops"] / (
            b.step_time * kw["n_chips"] * rl.PEAK_FLOPS), rel_tol=1e-12)
    assert b.to_dict().keys() == a.to_dict().keys()


def test_h100_constants_are_the_data_sheets():
    assert rl.PEAK_FLOPS == 989e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9
    assert rl.HBM_BYTES == 80e9
    assert rl.PEAK_BYTES_PER_S["cuda"] == rl.HBM_BW
    assert rl.PEAK_BF16_FLOPS_PER_S["cuda"] == rl.PEAK_FLOPS


def test_format_table_renders_the_references_markdown():
    rows = [ref.Roofline(name=f"cell{i}", n_chips=i + 1, hlo_flops=1e12 * i,
                         hlo_bytes=1e12 / (i + 1), collective_bytes=1e9,
                         model_flops=5e11).to_dict() for i in range(3)]
    assert rl.format_table(rows) == ref.format_table(rows)


def test_collective_stats_from_a_cost():
    from repro_torch.analysis.op_cost import Cost
    cost = Cost(coll_bytes=12.0, coll_by_kind={"all-reduce": 8.0,
                                               "all-gather": 4.0},
                coll_count_by_kind={"all-reduce": 2, "all-gather": 1})
    stats = rl.collective_stats(cost)
    assert stats.bytes_by_kind == {"all-reduce": 8, "all-gather": 4}
    assert stats.count_by_kind == {"all-reduce": 2, "all-gather": 1}
    assert stats.total_bytes == 12
    roof = rl.from_cost("c", cost, n_chips=2, model_flops=1.0)
    assert roof.collective_bytes == 24.0
    assert roof.to_dict()["collective_breakdown"] == stats.bytes_by_kind


# PERF.md §6: each bound at its kernel's main-path shape, to 1e-4 ms
@pytest.mark.parametrize("got,want", [
    (lambda: rl.dpxor_bound_ms(2 ** 25, 8, 1), 0.3606),
    (lambda: rl.fused_xor_bound(2 ** 25, 8, 32, 11, 12)[0], 18.4783),
    (lambda: rl.gemm_bound_ms(2 ** 25, 32, 1), 0.3305),
    (lambda: rl.ggm_bound(2 ** 24, 12)["bound_ms"], 0.3005),
    (lambda: rl.fused_add_bound_ms(2 ** 25, 32, 10, 12), 36.9565),
    (lambda: rl.lwe_gemm_bound(32, 2 ** 22, 32)[0], 0.3205),
    (lambda: rl.lwe_gemm_bound(32, 2 ** 22, 1024)[0], 8.2166),
], ids=["dpxor", "fused_xor", "pir_gemm", "ggm", "fused_add", "lwe_gemm",
     "lwe_hint"])
def test_kernel_bounds_at_perf_shapes(got, want):
    assert abs(got() - want) < 1e-4


def test_bound_kinds():
    assert rl.fused_xor_bound(2 ** 25, 8, 32, 11, 12)[1] == "operations"
    assert rl.fused_xor_bound(2 ** 17, 3584, 32, 11, 12)[1] == "bytes"
    assert rl.ggm_bound(2 ** 24, 12)["bound_by"] == "bytes"
    assert rl.lwe_gemm_bound(32, 2 ** 22, 32)[1] == "bytes"
    assert rl.lwe_gemm_bound(32, 2 ** 22, 1024)[1] == "operations"
