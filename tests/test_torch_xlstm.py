"""Port: the SSM family's configuration and mixers (``configs/xlstm_350m``,
``configs.cell_is_skipped``, ``models/ssm.py``) against the reference on
the CPU — ``ssd_scan`` over one chunk, several chunks and from a state,
``ssd_step``, ``causal_conv`` with and without a tail, and the mLSTM and
sLSTM mixers on their scan and one-step paths.

Inputs are drawn once in float32 with numpy from a seed and handed to
both packages in the dtype under test (both round to nearest even); the
mixers' weights are the reference's ``mlstm_init`` / ``slstm_init`` from
``PRNGKey(0)``, converted bit for bit. Tolerances, each with what was
measured:
* ``ssd_scan`` / ``ssd_step``, float32 inputs: rtol 1e-5 / atol 1e-5 of
  outputs and states of magnitude up to 3.4 (measured at most 1.7e-6:
  the port reassociates the three-operand contractions);
* ``causal_conv``, float32: atol 1e-6 (measured 1.2e-7, XLA's order of
  the four taps); bfloat16: the tail bit-equal and the output within two
  bf16 ulps (measured: two at most, 41 % of the elements one or two
  apart; the four bf16 products are added left to right in bf16 in both
  packages, equal bit for bit before the SiLU, and XLA's bf16 SiLU rounds
  otherwise than torch's);
* the sLSTM scan's hand-written backward: ``torch.autograd.gradcheck`` in
  float64 (its defaults), and against autograd through a plain loop of
  the same steps within 1e-12 (measured 8.9e-16);
* the mixers' outputs within ``MIX_REL`` of the reference's largest
  magnitude (0.0127 for the mLSTM, 2.03 for the sLSTM): float32 1e-5
  (measured 3.1e-7 and 3.5e-7 of it), bfloat16 2^-5 (measured 2^-6.9
  for the mLSTM, whose SiLUs and sigmoids round otherwise than XLA's, and
  0 for the sLSTM); their states (magnitude up to 4.0) float32 rtol 1e-4
  / atol 1e-5 (measured 7.2e-7), bfloat16 atol 2e-3 (measured 3.7e-4).
torch is pinned to one thread.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import LONG_CONTEXT_ARCHS as REF_LONG
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_is_skipped as ref_skipped
from repro.configs import get_arch as ref_get_arch
from repro.models import ssm as RS
from repro_torch.configs import (ARCHS, LONG_CONTEXT_ARCHS, NOT_PORTED,
                                 SHAPES, SMOKES, cell_is_skipped, get_arch)
from repro_torch.convert import tensor_from_reference
from repro_torch.models import ssm as PS

ARCH = "xlstm-350m"
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]
#: the mixers' outputs (relative to the reference's largest magnitude)
#: and states against the reference's, by dtype
MIX_REL = {"float32": 1e-5, "bfloat16": 2 ** -5}
STATE_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
             "bfloat16": dict(rtol=0, atol=2e-3)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def both(arr: np.ndarray, dtype: str):
    return (jnp.asarray(arr, JNP_DT[dtype]),
            torch.from_numpy(np.ascontiguousarray(arr)).to(TORCH_DT[dtype]))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


# -- configs ----------------------------------------------------------------------

def test_xlstm_config_is_the_reference():
    """FULL and SMOKE field for field, ``n_params`` (which counts every
    block as an mLSTM, in both packages), the 7 : 1 pattern, and the
    registry with no arch left unported."""
    for smoke in (False, True):
        cfg, ref = get_arch(ARCH, smoke=smoke), ref_get_arch(ARCH,
                                                             smoke=smoke)
        assert cfg.to_dict() == ref.to_dict() and cfg.family == "ssm"
        assert cfg.n_params() == ref.n_params()
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab,
            full.ssm.chunk, full.ssm.block_pattern) == \
        (24, 1024, 4, 50304, 256, ("mlstm",) * 7 + ("slstm",))
    assert ARCH in ARCHS and NOT_PORTED == {}
    assert LONG_CONTEXT_ARCHS == REF_LONG


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_cell_is_skipped_matches_the_reference(arch):
    """Every (arch, shape) of the reference's grid: the same verdict;
    ``long_500k`` runs only for the SSM and hybrid archs."""
    assert SHAPES.keys() == REF_SHAPES.keys()
    for shape in SHAPES:
        assert cell_is_skipped(arch, shape) == ref_skipped(arch, shape), \
            (arch, shape)
    assert cell_is_skipped(arch, "long_500k") == (arch not in REF_LONG)


# -- the SSD core -----------------------------------------------------------------

def ssd_inputs(seed, b, l, h, p, n, *, decay=1.0):
    """x [B, L, H, P], log_a <= 0 [B, L, H], b / c [B, L, N] (unit-norm
    rows scaled by 1/sqrt(N)), float32 numpy."""
    x = randn(seed, b, l, h, p)
    log_a = -np.abs(randn(seed + 1, b, l, h)) * decay
    bi = randn(seed + 2, b, l, n) / np.sqrt(n)
    co = randn(seed + 3, b, l, n) / np.sqrt(n)
    return x, log_a, bi, co


SCAN_CASES = {
    # name: (B, L, H, P, N, chunk, with init_state)
    "one_chunk": (2, 16, 3, 5, 4, 16, False),
    "short_of_the_chunk": (2, 12, 3, 5, 4, 16, False),
    "chunks": (2, 48, 3, 5, 4, 16, False),
    "init_state": (2, 32, 3, 5, 4, 8, True),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ssd_scan_matches_the_reference(case):
    b, l, h, p, n, chunk, with_state = SCAN_CASES[case]
    x, log_a, bi, co = ssd_inputs(7, b, l, h, p, n)
    s0 = randn(11, b, h, p, n) if with_state else None
    ry, rs = jax.jit(lambda *a: RS.ssd_scan(*a[:4], chunk=chunk,
                                            init_state=a[4]))(
        x, log_a, bi, co, s0)
    t = lambda a: None if a is None else torch.from_numpy(a)
    py, ps = PS.ssd_scan(t(x), t(log_a), t(bi), t(co), chunk=chunk,
                         init_state=t(s0))
    assert py.shape == (b, l, h, p) and ps.shape == (b, h, p, n)
    assert py.dtype == ps.dtype == torch.float32
    close(py, ry, rtol=1e-5, atol=1e-5)
    close(ps, rs, rtol=1e-5, atol=1e-5)


def test_ssd_scan_keeps_x_dtype_and_raises_as_the_reference():
    """A bf16 x gives a bf16 y and a float32 state; L = 20 at chunk 16
    raises the reference's ValueError in both packages."""
    x, log_a, bi, co = ssd_inputs(3, 1, 32, 2, 4, 4)
    t = torch.from_numpy
    y, s = PS.ssd_scan(t(x).bfloat16(), t(log_a), t(bi), t(co), chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    for scan, conv in ((RS.ssd_scan, jnp.asarray), (PS.ssd_scan, t)):
        with pytest.raises(ValueError, match="L=20 not divisible by "
                           "chunk=16"):
            scan(*(conv(a[:, :20]) for a in (x, log_a, bi, co)), chunk=16)


def test_ssd_step_matches_the_reference_and_chains_to_the_scan():
    """One step against the reference's; L steps from a state equal the
    scan over L from that state (port against port)."""
    b, l, h, p, n = 2, 8, 3, 5, 4
    x, log_a, bi, co = ssd_inputs(5, b, l, h, p, n)
    s0 = randn(6, b, h, p, n)
    ry, rs = jax.jit(RS.ssd_step)(x[:, 0], log_a[:, 0], bi[:, 0], co[:, 0],
                                  s0)
    t = torch.from_numpy
    py, ps = PS.ssd_step(t(x[:, 0]), t(log_a[:, 0]), t(bi[:, 0]),
                         t(co[:, 0]), t(s0))
    close(py, ry, rtol=1e-5, atol=1e-5)
    close(ps, rs, rtol=1e-5, atol=1e-5)
    state, ys = t(s0), []
    for i in range(l):
        y, state = PS.ssd_step(t(x[:, i]), t(log_a[:, i]), t(bi[:, i]),
                               t(co[:, i]), state)
        ys.append(y)
    sy, ss = PS.ssd_scan(t(x), t(log_a), t(bi), t(co), chunk=4,
                         init_state=t(s0))
    torch.testing.assert_close(torch.stack(ys, 1), sy, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(state, ss, rtol=1e-5, atol=1e-5)


def test_ssd_scan_gradients_stay_finite_at_a_long_chunk():
    """C5 on the bare scan: chunk 256, every log_a = -0.69 (gate logits
    near 0). The reference's output and dx are finite, its d log_a is not
    (exp of the unmasked upper triangle overflows, 0 x inf); the port's
    every gradient is finite and its output the reference's."""
    b, l, h, p, n = 1, 256, 1, 3, 4
    x, _, bi, co = ssd_inputs(9, b, l, h, p, n)
    log_a = np.full((b, l, h), -0.69, np.float32)
    f = lambda x, a: jnp.sum(RS.ssd_scan(x, a, bi, co, chunk=256)[0])
    rout = jax.jit(lambda x, a: RS.ssd_scan(x, a, bi, co, chunk=256)[0])(
        x, log_a)
    rgx, rga = jax.jit(jax.grad(f, argnums=(0, 1)))(x, log_a)
    assert np.isfinite(np.asarray(rout)).all()
    assert np.isfinite(np.asarray(rgx)).all()
    assert not np.isfinite(np.asarray(rga)).all()
    tx = torch.from_numpy(x).requires_grad_(True)
    ta = torch.from_numpy(log_a).requires_grad_(True)
    out, _ = PS.ssd_scan(tx, ta, torch.from_numpy(bi), torch.from_numpy(co),
                         chunk=256)
    gx, ga = torch.autograd.grad(out.sum(), (tx, ta))
    assert torch.isfinite(gx).all() and torch.isfinite(ga).all()
    close(out, rout, rtol=1e-5, atol=1e-5)
    close(gx, rgx, rtol=1e-4, atol=1e-5)


# -- the causal conv -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
def test_causal_conv_matches_the_reference(dtype, tail):
    x, w = randn(1, 2, 24, 64), randn(2, 4, 64) * 0.1
    st = randn(3, 2, 3, 64) if tail else None
    rx, px = both(x, dtype)
    rw, pw = both(w, dtype)
    rst, pst = both(st, dtype) if tail else (None, None)
    ry, rt = jax.jit(lambda x, w, s: RS.causal_conv(x, w, state=s))(
        rx, rw, rst)
    py, pt = PS.causal_conv(px, pw, state=pst)
    assert py.dtype == pt.dtype == TORCH_DT[dtype]
    assert np.array_equal(as_np(pt), as_np(rt))
    want = as_np(ry)
    if dtype == "float32":
        np.testing.assert_allclose(as_np(py), want, rtol=0, atol=1e-6)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(as_np(py) - want) <= 2 * ulp).all()


# -- the mixers ------------------------------------------------------------------

def mixer_params(kind: str, dtype: str):
    """The reference's mixer weights from PRNGKey(0) at SMOKE width (as
    jax arrays) and the port's (same bits)."""
    cfg = replace(ref_get_arch(ARCH, smoke=True), dtype=dtype)
    init = RS.mlstm_init if kind == "mlstm" else RS.slstm_init
    ref = init(jax.random.PRNGKey(0), cfg)
    port = {k: tensor_from_reference(np.asarray(v)) for k, v in ref.items()}
    return cfg, ref, port


def mix_close(got, want, dtype):
    want = as_np(want)
    close(got, want, rtol=0, atol=MIX_REL[dtype] * np.abs(want).max())


def caches_close(got, want, dtype):
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w, **STATE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_scan_and_step_match_the_reference(kind, dtype):
    """The scan over 32 tokens (two chunks), then one step on its cache,
    then a scan of 16 more tokens from that cache: outputs and every cache
    tensor against the reference's."""
    rcfg, rparams, pparams = mixer_params(kind, dtype)
    pcfg = replace(SMOKES[ARCH], dtype=dtype)
    rapply = RS.mlstm_apply if kind == "mlstm" else RS.slstm_apply
    papply = PS.mlstm_apply if kind == "mlstm" else PS.slstm_apply
    run = jax.jit(lambda p, x, c: rapply(p, rcfg, x, cache=c))
    x = randn(21, 2, 49, 64)
    rx, px = both(x, dtype)
    ry, rc = run(rparams, rx[:, :32], None)
    py, pc = papply(pparams, pcfg, px[:, :32])
    assert py.dtype == TORCH_DT[dtype]
    mix_close(py, ry, dtype)
    caches_close(pc, rc, dtype)
    ry1, rc1 = run(rparams, rx[:, 32:33], rc)
    py1, pc1 = papply(pparams, pcfg, px[:, 32:33], cache=pc)
    mix_close(py1, ry1, dtype)
    caches_close(pc1, rc1, dtype)
    ry2, rc2 = run(rparams, rx[:, 33:], rc1)
    py2, pc2 = papply(pparams, pcfg, px[:, 33:], cache=pc1)
    mix_close(py2, ry2, dtype)
    caches_close(pc2, rc2, dtype)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_cache_init_matches_the_reference(kind):
    """The zero caches: shapes, dtypes and values (sLSTM's n at 1e-6)."""
    cfg = ref_get_arch(ARCH, smoke=True)
    rinit = RS.mlstm_cache_init if kind == "mlstm" else RS.slstm_cache_init
    pinit = PS.mlstm_cache_init if kind == "mlstm" else PS.slstm_cache_init
    want = rinit(cfg, 3)
    got = pinit(SMOKES[ARCH], 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.device.type == "cpu"
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert np.array_equal(as_np(g), as_np(w))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_init_draws_the_reference_distributions(kind):
    """The port's draws: each tensor of the reference's shape and dtype
    (``r_rec`` float32 in a bf16 config), norms zero, matrices within
    ±1/sqrt(d_in) (``r_rec`` a tenth of that), ``conv_w`` of std near
    0.1."""
    cfg = SMOKES[ARCH]
    _, ref, _ = mixer_params(kind, "bfloat16")
    init = PS.mlstm_init if kind == "mlstm" else PS.slstm_init
    got = init(torch.Generator().manual_seed(0), cfg)
    assert got.keys() == ref.keys()
    for name, w in got.items():
        assert tuple(w.shape) == ref[name].shape, name
        assert str(w.dtype).split(".")[-1] == str(ref[name].dtype), name
        wf = w.float()
        if name == "norm":
            assert not wf.any()
        elif name == "conv_w":
            assert 0.08 < float(wf.std()) < 0.12
        else:
            bound = 1 / np.sqrt(w.shape[0]) * (0.1 if name == "r_rec"
                                               else 1.0)
            assert float(wf.abs().max()) <= bound * (1 + 2 ** -8)
            assert float(wf.abs().max()) > 0.9 * bound


# -- the sLSTM scan's backward ------------------------------------------------------

def slstm_inputs(seed, l=6, b=2, d=3):
    """float64 (pre [L, B, 4d], r [d, 4d], c0, n0 > 0, h0, m0), each
    requiring its gradient."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g,
                                    dtype=torch.float64)
    ins = (rn(l, b, 4 * d), rn(d, 4 * d) * 0.3, rn(b, d),
           torch.rand(b, d, generator=g, dtype=torch.float64) + 0.5,
           rn(b, d), rn(b, d))
    return tuple(t.requires_grad_(True) for t in ins)


def plain_slstm(pre, r, c, n, h, m):
    """The reference's cell, step by step, through autograd."""
    d = c.shape[-1]
    hs = []
    for t in range(pre.shape[0]):
        ig, fg, zg, og = (pre[t] + h @ r).split(d, -1)
        log_f = torch.nn.functional.logsigmoid(fg)
        m_new = torch.maximum(log_f + m, ig)
        c = (torch.exp(log_f + m - m_new) * c
             + torch.exp(ig - m_new) * torch.tanh(zg))
        n = torch.exp(log_f + m - m_new) * n + torch.exp(ig - m_new)
        h = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs), c, n, h, m


def test_slstm_scan_backward_is_the_gradient():
    """The scan's one autograd node: its hand-written backward passes
    gradcheck (every input: the projections, ``r``, the initial state),
    and its outputs and gradients equal autograd's through a plain loop of
    the same steps."""
    ins = slstm_inputs(0)
    assert torch.autograd.gradcheck(PS._SLSTMScan.apply, ins)
    got = PS._SLSTMScan.apply(*ins)
    want = plain_slstm(*ins)
    weights = [torch.randn_like(t) for t in want]
    grads = [torch.autograd.grad(sum((w * t).sum()
                                     for w, t in zip(weights, out)), ins)
             for out in (got, want)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_slstm_apply_takes_the_scan_node_only_for_gradients():
    """Under no_grad (prefill, decode) the loop runs without an autograd
    node and returns the same values; the final state holds no step's
    buffer beyond its own rows."""
    _, _, params = mixer_params("slstm", "float32")
    cfg = replace(SMOKES[ARCH], dtype="float32")
    x = torch.from_numpy(randn(4, 2, 8, 64))
    with torch.no_grad():
        y0, st0 = PS.slstm_apply(params, cfg, x)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y1, st1 = PS.slstm_apply(p, cfg, x)
    assert y1.grad_fn is not None and y0.grad_fn is None
    torch.testing.assert_close(y0, y1.detach(), rtol=0, atol=0)
    for a, b in zip(st0, st1):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
        assert a.untyped_storage().nbytes() == a.numel() * 4
