"""Port: the hybrid family's configuration and Mamba2 mixer
(``configs/zamba2_7b``, ``models/ssm.py``'s ``mamba2_*``) against the
reference on the CPU — the configs, ``mamba2_init``'s shapes and draws,
``mamba2_apply`` on its scan path, its decode step and scanning on from
a cache, and its gradients at zamba2-7b's published chunk of 256
(ROADMAP §C5).

Inputs are drawn once in float32 with numpy from a seed and handed to
both packages in the dtype under test; the mixer's weights are the
reference's ``mamba2_init`` from ``PRNGKey(0)``, converted bit for bit.
Tolerances, each with what was measured:
* outputs within ``MIX_REL`` of the reference's largest magnitude (0.45
  to 0.93): float32 1e-5 (measured at most 5.6e-7 of it), bfloat16 2^-5
  (measured at most 2^-6.8: the SiLUs and the softplus round otherwise
  than XLA's);
* the SSD states (magnitude up to 0.043) within ``MIX_REL`` of their
  largest magnitude: float32 (measured 8.1e-7 of it), bfloat16 (measured
  2^-6.6); the conv tails (the model dtype) float32 atol 1e-6 (measured
  4.8e-7), bfloat16 bit-equal (measured: equal);
* gradients, float32, against the reference's at chunk 16: rtol 1e-4
  and atol 1e-5 of the leaf's largest magnitude (0.12 to 49: a weighted
  sum over 256 positions, which the two chunkings add in another order;
  measured at most 3.1e-5 off, on ``out_proj``, whose largest is 39, and
  4.3e-6 on ``a_log``, whose largest is 0.12).
torch is pinned to one thread.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import ssm as RS
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.convert import tensor_from_reference
from repro_torch.models import ssm as PS

ARCH = "zamba2-7b"
DTYPES = ["float32", "bfloat16"]
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: outputs and states against the reference's, relative to its largest
#: magnitude, by dtype
MIX_REL = {"float32": 1e-5, "bfloat16": 2 ** -5}
TAIL_ATOL = {"float32": 1e-6, "bfloat16": 0.0}
GRAD_TOL = dict(rtol=1e-4, atol_rel=1e-5)
B = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def rel_close(got, want, dtype):
    want = as_np(want)
    np.testing.assert_allclose(as_np(got), want, rtol=0,
                               atol=MIX_REL[dtype] * np.abs(want).max())


_MIXERS = {}


def mixer(dtype: str):
    """(reference config, reference params as jnp, port config, port
    params), once a dtype."""
    if dtype not in _MIXERS:
        rcfg = replace(ref_get_arch(ARCH, smoke=True), dtype=dtype)
        pcfg = replace(SMOKES[ARCH], dtype=dtype)
        rp = RS.mamba2_init(jax.random.PRNGKey(0), rcfg)
        pp = {k: tensor_from_reference(np.asarray(v)) for k, v in rp.items()}
        _MIXERS[dtype] = (rcfg, rp, pcfg, pp)
    return _MIXERS[dtype]


def both(arr: np.ndarray, dtype: str):
    return (jnp.asarray(arr, JNP_DT[dtype]),
            torch.from_numpy(np.ascontiguousarray(arr)).to(TORCH_DT[dtype]))


# -- configs and the registry -------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_zamba2_config_is_the_reference(smoke):
    """``get_arch("zamba2-7b")`` returns the port's config, field for field
    the reference's, with its ``n_params``."""
    cfg, ref = get_arch(ARCH, smoke=smoke), ref_get_arch(ARCH, smoke=smoke)
    assert cfg is (SMOKES if smoke else ARCHS)[ARCH]
    assert cfg.to_dict() == ref.to_dict() and cfg.family == "hybrid"
    assert cfg.n_params() == ref.n_params()
    if not smoke:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab, cfg.ssm.d_state, cfg.ssm.chunk,
                cfg.ssm.shared_attn_every) == \
            (81, 3584, 32, 32, 14336, 32000, 64, 256, 6)


# -- Mamba2's parameters -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_shapes_and_init_are_the_reference(dtype):
    """``mamba2_shapes`` names the reference's leaves with their shapes and
    dtypes (``a_log``, ``dt_bias``, ``d_skip`` float32 in a bf16 model);
    ``mamba2_init`` draws them as the reference: a_log 0, softplus(dt_bias)
    1, d_skip 1, the norm 0, ``conv_w`` of std near 0.1, the matrices
    within ±1/sqrt(d_in)."""
    rcfg, rp, pcfg, _ = mixer(dtype)
    shapes = PS.mamba2_shapes(pcfg)
    assert {k: (tuple(s), str(dt).split(".")[-1])
            for k, (s, dt) in shapes.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in rp.items()}
    got = PS.mamba2_init(torch.Generator().manual_seed(3), pcfg)
    for k, (s, dt) in shapes.items():
        assert got[k].shape == s and got[k].dtype == dt, k
    assert not got["a_log"].any() and not got["norm"].any()
    assert (got["d_skip"] == 1).all()
    np.testing.assert_allclose(
        torch.nn.functional.softplus(got["dt_bias"]).numpy(), 1.0,
        rtol=1e-6)
    np.testing.assert_array_equal(got["dt_bias"].numpy(),
                                  np.asarray(rp["dt_bias"]))
    assert 0.08 < float(got["conv_w"].float().std()) < 0.12
    d, d_inner = pcfg.d_model, pcfg.ssm.expand * pcfg.d_model
    assert float(got["in_proj"].float().abs().max()) <= 1 / np.sqrt(d)
    assert float(got["out_proj"].float().abs().max()) <= 1 / np.sqrt(d_inner)


def test_mamba2_cache_init():
    """Zero conv tail [B, K-1, d_inner + 2N] in the model dtype and a zero
    float32 SSD state [B, H, P, N], as the reference's."""
    rcfg, _, pcfg, _ = mixer("bfloat16")
    want = RS.mamba2_cache_init(rcfg, B)
    got = PS.mamba2_cache_init(pcfg, B)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in got] == \
        [(w.shape, str(w.dtype)) for w in want]
    assert not any(t.any() for t in got)


# -- mamba2_apply ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_scan_matches_the_reference(dtype):
    """The scan path over 32 positions (two chunks of 16): the output, the
    conv tail and the final SSD state."""
    rcfg, rp, pcfg, pp = mixer(dtype)
    jx, tx = both(randn(1, B, 32, pcfg.d_model), dtype)
    want, (w_tail, w_state) = jax.jit(
        lambda p, x: RS.mamba2_apply(p, rcfg, x))(rp, jx)
    got, (g_tail, g_state) = PS.mamba2_apply(pp, pcfg, tx)
    assert got.dtype == TORCH_DT[dtype] and g_state.dtype == torch.float32
    rel_close(got, want, dtype)
    rel_close(g_state, w_state, dtype)
    np.testing.assert_allclose(as_np(g_tail), as_np(w_tail), rtol=0,
                               atol=TAIL_ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("steps", [1, 16], ids=["decode", "scan_on"])
def test_mamba2_from_a_cache_matches_the_reference(dtype, steps):
    """From the cache of a 32-position scan: five one-token decode steps
    (``ssd_step``), or a 16-position scan that starts from the cache's
    state and conv tail; each output and the final cache."""
    rcfg, rp, pcfg, pp = mixer(dtype)
    jx, tx = both(randn(1, B, 32, pcfg.d_model), dtype)
    _, rc = jax.jit(lambda p, x: RS.mamba2_apply(p, rcfg, x))(rp, jx)
    _, pc = PS.mamba2_apply(pp, pcfg, tx)
    rstep = jax.jit(lambda p, x, c: RS.mamba2_apply(p, rcfg, x, cache=c))
    n = 5 if steps == 1 else 1
    xs = randn(2, B, n * steps, pcfg.d_model)
    for i in range(n):
        jx, tx = both(xs[:, i * steps:(i + 1) * steps], dtype)
        want, rc = rstep(rp, jx, rc)
        got, pc = PS.mamba2_apply(pp, pcfg, tx, cache=pc)
        assert got.shape == want.shape
        rel_close(got, want, dtype)
    rel_close(pc[1], rc[1], dtype)
    np.testing.assert_allclose(as_np(pc[0]), as_np(rc[0]), rtol=0,
                               atol=TAIL_ATOL[dtype])


def test_mamba2_gradients_at_the_published_chunk():
    """float32, 256 positions: at chunk 256 the reference's output equals
    its chunk-16 output, but its gradients with respect to ``a_log``,
    ``dt_bias``, ``in_proj`` and ``conv_w`` are non-finite (the unmasked decay block's
    exp overflows: dt·|A| is about 1 a step, so its upper triangle reaches
    about 255; C5); the port's are finite and equal the reference's at
    chunk 16."""
    rcfg, rp, pcfg, pp = mixer("float32")
    x = randn(4, B, 256, pcfg.d_model)
    w = randn(5, B, 256, pcfg.d_model)

    def ref_grads(chunk):
        cfg = replace(rcfg, ssm=replace(rcfg.ssm, chunk=chunk))
        f = lambda p: jnp.sum(RS.mamba2_apply(p, cfg, jnp.asarray(x))[0]
                              * jnp.asarray(w))
        val, grads = jax.jit(jax.value_and_grad(f))(rp)
        return float(val), {k: np.asarray(v) for k, v in grads.items()}

    val16, want = ref_grads(16)
    val256, bad = ref_grads(256)
    np.testing.assert_allclose(val256, val16, rtol=1e-5)
    non_finite = sorted(k for k, g in bad.items() if not np.isfinite(g).all())
    assert non_finite == ["a_log", "conv_w", "dt_bias", "in_proj"]
    assert all(np.isfinite(g).all() for g in want.values())
    cfg = replace(pcfg, ssm=replace(pcfg.ssm, chunk=256))
    params = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    out, _ = PS.mamba2_apply(params, cfg, torch.from_numpy(x))
    val = torch.sum(out * torch.from_numpy(w))
    np.testing.assert_allclose(float(val.detach()), val16, rtol=1e-5)
    grads = torch.autograd.grad(val, list(params.values()))
    for name, g in zip(params, grads):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(
            g.numpy(), want[name], err_msg=name, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol_rel"] * np.abs(want[name]).max())
