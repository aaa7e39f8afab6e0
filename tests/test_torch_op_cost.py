"""The op-level cost counter (``repro_torch/analysis/op_cost.py``), held to
what ``tests/test_analysis.py`` asks of the reference's HLO cost analyzer
(``repro/analysis/hlo_cost.py``), and the six custom ops' fakes.

The counter runs a function on meta tensors under a TorchDispatchMode; the
reference compiles it and reads the HLO. Both count a matmul's 2 M N K,
a loop's body once per trip, a gathered row instead of its table, and a
collective's output bytes by kind.
"""
import socket

import numpy as np
import pytest
import torch

from repro_torch.analysis import op_cost
from repro_torch.kernels import ops

META = torch.device("meta")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_flops_single_matmul():
    cost = op_cost.analyze(lambda a, b: a @ b, meta(128, 64), meta(64, 32))
    assert cost.flops == 2 * 128 * 64 * 32
    assert cost.elem_flops == 0
    assert cost.bytes == (128 * 64 + 64 * 32 + 128 * 32) * 4
    assert cost.unknown_loops == 0


def _chain(x, w, n):
    for _ in range(n):
        x = x @ w
    return x


def test_flops_loop_multiplied():
    cost = op_cost.analyze(_chain, meta(64, 64), meta(64, 64), 13)
    assert cost.flops == 13 * 2 * 64 ** 3
    assert cost.unknown_loops == 0


def test_flops_nested_loop():
    def f(x, w):
        for _ in range(3):
            x = _chain(x, w, 4)
        return x
    cost = op_cost.analyze(f, meta(32, 32), meta(32, 32))
    assert cost.flops == 12 * 2 * 32 ** 3


@pytest.mark.parametrize("gather", ["index", "embedding", "index_select",
                                    "narrow"])
def test_gathered_row_not_full_operand(gather):
    """One row of a [4096, 1024] table must not count the whole table."""
    fns = {
        "index": lambda t, i: t[i],
        "embedding": lambda t, i: torch.nn.functional.embedding(i, t),
        "index_select": lambda t, i: t.index_select(0, i),
        "narrow": lambda t, i: t.narrow(0, 0, 1).clone(),
    }
    table = meta(4096, 1024)
    idx = torch.zeros(1, dtype=torch.long, device=META)
    cost = op_cost.analyze(fns[gather], table, idx)
    assert cost.bytes < 4096 * 1024 * 4 * 0.5


def test_region_writes_pay_for_the_rows_they_touch():
    cache = meta(64, 4096, 128)
    rows = meta(64, 1, 128)
    pos = torch.zeros(1, dtype=torch.long, device=META)
    cost = op_cost.analyze(lambda c, r, p: c.index_copy_(1, p, r), cache,
                           rows, pos)
    assert cost.bytes == 2 * 64 * 128 * 4 + 8
    cost = op_cost.analyze(lambda c, r: c[:, :1].copy_(r), cache, rows)
    assert cost.bytes == 2 * 64 * 128 * 4
    cost = op_cost.analyze(lambda c, r: c[:, :1].add_(r), cache, rows)
    assert cost.bytes == 3 * 64 * 128 * 4


def test_views_cost_nothing():
    x = meta(64, 32)
    cost = op_cost.analyze(lambda x: x.view(32, 64).t().expand(2, 64, 32)
                           [:, 1:].transpose(0, 1), x)
    assert (cost.bytes, cost.flops, cost.elem_flops) == (0, 0, 0)


def test_peak_live_bytes_follows_frees():
    n = 256 * 1024 * 4
    cost = op_cost.analyze(lambda x: (x * 2) + 1, meta(256, 1024))
    assert cost.argument_bytes == n
    assert cost.peak_live_bytes == 3 * n      # x, the temporary, the sum
    assert cost.output_bytes == n

    def chain(x):
        for _ in range(10):
            x = x * 2                          # each result frees the last
        return x
    cost = op_cost.analyze(chain, meta(256, 1024))
    assert cost.peak_live_bytes == 3 * n
    assert cost.elem_flops == 10 * 256 * 1024
    # an in-place update returns its argument: no new output
    cost = op_cost.analyze(lambda x: x.mul_(2), meta(256, 1024))
    assert (cost.peak_live_bytes, cost.output_bytes) == (n, 0)


def test_resident_tensors_count_from_the_start():
    lin = torch.nn.Linear(1024, 1024, bias=False, device=META)
    x = meta(8, 1024)
    cost = op_cost.analyze(lambda x: lin(x), x, resident=(lin,))
    assert cost.argument_bytes == (1024 * 1024 + 8 * 1024) * 4
    assert cost.flops == 2 * 8 * 1024 * 1024


def test_remat_recompute_is_counted():
    w = torch.empty(256, 256, device=META, requires_grad=True)

    def block(h):
        return torch.relu(h @ w) @ w

    def step(x, remat):
        h = (torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
             if remat else block(x))
        return torch.autograd.grad(h.sum(), [w])
    x = meta(64, 256)
    plain = op_cost.analyze(step, x, False, resident=(w,))
    remat = op_cost.analyze(step, x, True, resident=(w,))
    # the backward recomputes h @ w for relu's output and stops there (the
    # second product's output is not saved)
    assert remat.flops - plain.flops == 2 * 64 * 256 * 256
    assert remat.peak_live_bytes <= plain.peak_live_bytes


def _custom_cases():
    i32, i8 = torch.int32, torch.int8
    r, w, q, clog = 1 << 12, 8, 3, 8
    c = r >> clog
    return {
        "dpxor": (ops.dpxor, ((r, w, i32), (q, r, i32)), (q, w)),
        "fused_scan_xor": (
            lambda *a: ops.fused_scan_xor(*a),
            ((r, w, i32), (q, c, 4, i32), (q, c, i32), (q, clog, 4, i32),
             (q, clog, 2, i32)), (q, w)),
        "fused_scan_add": (
            lambda *a: ops.fused_scan_bytes(*a, party=1),
            ((r, 32, i8), (q, c, 4, i32), (q, c, i32), (q, clog, 4, i32),
             (q, clog, 2, i32), (q, i32)), (q, 32)),
        "pir_gemm": (ops.pir_gemm, ((q, r, i8), (r, 32, i8)), (q, 32)),
        "lwe_gemm": (ops.lwe_gemm, ((q, r, i32), (r, 32, i32)), (q, 32)),
        "ggm_expand": (lambda *a: ops.ggm_expand(*a),
                       ((r, 4, i32), (r, i32), (4, i32), (2, i32)),
                       ((2 * r, 4), (2 * r,))),
    }


CUSTOM = _custom_cases()


@pytest.mark.parametrize("name", sorted(CUSTOM))
def test_custom_op_costs_operands_plus_outputs(name):
    fn, specs, _ = CUSTOM[name]
    args = [meta(*s[:-1], dtype=s[-1]) for s in specs]
    before = ops.counts()[name]
    cost = op_cost.analyze(fn, *args)
    want_in = sum(a.numel() * a.element_size() for a in args)
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    want_out = sum(o.numel() * o.element_size() for o in outs)
    # the wrapper's .contiguous() copies nothing: every operand is dense
    assert cost.bytes == want_in + want_out
    assert (cost.flops, cost.elem_flops) == (0, 0)
    assert ops.counts()[name] == before     # the fake launched nothing


def _cpu_operand(shape, dtype, rng):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-128, 128, shape, np.int8))
    return torch.from_numpy(rng.integers(0, 2, shape, np.int32))


@pytest.mark.parametrize("name", sorted(CUSTOM))
def test_fake_matches_the_plain_versions_output(name):
    """Each fake's output shapes and dtypes equal the plain version's on
    the CPU (the fake runs for meta tensors, the plain version for CPU
    ones; the kernel itself only on the card)."""
    fn, specs, want = CUSTOM[name]
    rng = np.random.default_rng(36)
    cpu = [_cpu_operand(s[:-1], s[-1], rng) for s in specs]
    fake = fn(*[meta(*s[:-1], dtype=s[-1]) for s in specs])
    plain = fn(*cpu)
    fake = fake if isinstance(fake, tuple) else (fake,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    want = want if isinstance(want[0], tuple) else (want,)
    assert len(fake) == len(plain) == len(want)
    for f, p, w in zip(fake, plain, want):
        assert f.device == META
        assert tuple(f.shape) == tuple(p.shape) == w
        assert f.dtype == p.dtype == torch.int32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_collective_lands_in_coll_by_kind():
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fcol
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        x = torch.ones(8, 128)
        cost = op_cost.analyze(lambda x: dist.all_reduce(x), x)
        assert cost.coll_by_kind == {"all-reduce": 8 * 128 * 4}
        assert cost.coll_count_by_kind == {"all-reduce": 1}
        assert cost.coll_bytes == 8 * 128 * 4
        out = torch.empty(8, 128)
        cost = op_cost.analyze(
            lambda o, x: dist.all_gather_into_tensor(o, x), out, x)
        assert cost.coll_by_kind == {"all-gather": 8 * 128 * 4}
        cost = op_cost.analyze(
            lambda x: fcol.all_reduce(x, "sum", dist.group.WORLD) * 2, x)
        assert cost.coll_by_kind == {"all-reduce": 8 * 128 * 4}
    finally:
        dist.destroy_process_group()


def _hlo_flops(f, *shapes):
    import jax
    from repro.analysis import hlo_cost
    structs = [jax.ShapeDtypeStruct(s, np.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(f).lower(*structs).compile()
                            .as_text()).flops


def test_flops_agree_with_hlo_cost_on_a_matmul():
    want = _hlo_flops(lambda a, b: a @ b, (128, 64), (64, 32))
    got = op_cost.analyze(lambda a, b: a @ b, meta(128, 64),
                          meta(64, 32)).flops
    assert abs(got - want) / want < 0.05


def test_flops_agree_with_hlo_cost_on_a_13_step_chain():
    import jax
    import jax.numpy as jnp

    def f(x, w):
        def body(c, _):
            return c @ w, ()
        c, _ = jax.lax.scan(body, x, jnp.arange(13))
        return c
    want = _hlo_flops(f, (64, 64), (64, 64))
    got = op_cost.analyze(_chain, meta(64, 64), meta(64, 64), 13).flops
    assert abs(got - want) / want < 0.05
