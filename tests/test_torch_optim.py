"""Port: the optimizers and the gradient compression (``repro_torch/optim``)
against the reference on the CPU.

The same numpy-seeded gradients and the reference's parameters (drawn
from ``PRNGKey(0)``, stacked ``[L, ...]``) reach the port through
``convert.model_params_from_reference`` (unstacked to one tensor per
layer); optimizer states cross with ``convert.opt_state_from_reference``.
Tolerances: float32 rtol 1e-5 / atol 1e-6 on parameters and state (the
two frameworks round each elementwise op in float32, in orders that can
differ by an ulp; measured below 4e-7); bfloat16 parameters atol = rtol =
2^-7, one bf16 ulp (a float32 master an ulp apart can round to the
neighbouring bf16 value). The schedule and the norm: rtol 1e-6.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as RefOptimizerConfig
from repro.configs import SMOKES as REF_SMOKES
from repro.models import build_model as ref_build
from repro.optim import compression as rc
from repro.optim import optimizer as ro
from repro_torch.config import OptimizerConfig
from repro_torch.configs import SMOKES
from repro_torch.convert import (leaf_paths, model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.optim import compression as pc
from repro_torch.optim import optimizer as po

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at smoke shapes torch's threads buy nothing,
    and under the suite's parallel workers they contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(to_np(got), to_np(want), err_msg=what, **tol)


_TREES = {}


def ref_tree(arch: str, dtype: str):
    """(reference params tree, numpy copy, port config); the trees are
    drawn once per module."""
    if (arch, dtype) not in _TREES:
        rcfg = replace(REF_SMOKES[arch], dtype=dtype)
        params = jax.jit(ref_build(rcfg, remat="none").init_params)(
            jax.random.PRNGKey(0))
        _TREES[arch, dtype] = params, jax.tree_util.tree_map(np.asarray,
                                                             params)
    params, params_np = _TREES[arch, dtype]
    return params, params_np, replace(SMOKES[arch], dtype=dtype)


def grads_like(params_np, seed: int, scale: float = 0.05):
    """Random gradients shaped (and typed) like the parameter tree."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(p.dtype),
        params_np)


def to_port(tree_np, cfg):
    return model_params_from_reference(tree_np, cfg)


def both_cfgs(**kw):
    return RefOptimizerConfig(**kw), OptimizerConfig(**kw)


def check_params(got, want_tree, cfg, tol):
    want = to_port(jax.tree_util.tree_map(np.asarray, want_tree), cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        close(got[k], want[k], tol, k)


def check_state(got, want, cfg, tol):
    assert int(got.step) == int(want.step)
    assert got.step.dtype == torch.int32
    want_np = jax.tree_util.tree_map(np.asarray, want)
    if isinstance(got, po.AdamWState):
        for field in ("m", "v", "master"):
            w = to_port(getattr(want_np, field), cfg)
            for k in w:
                close(getattr(got, field)[k], w[k], tol, f"{field}/{k}")
        return
    for field in ("vr", "vc", "v"):
        w = dict(leaf_paths(getattr(want_np, field)))
        g = getattr(got, field)
        assert g.keys() == w.keys()
        for k in w:
            assert (g[k] is None) == (w[k] is None), (field, k)
            if w[k] is not None:
                assert tuple(g[k].shape) == w[k].shape, (field, k)
                close(g[k], w[k], tol, f"{field}/{k}")


# -- schedule and clipping ---------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (1, 1)])
def test_lr_schedule(warmup, total):
    rcfg, cfg = both_cfgs(lr=1e-3, warmup_steps=warmup, total_steps=total)
    for s in range(0, total + 5):
        got = po.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = ro.lr_schedule(rcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        close(got, want, dict(rtol=1e-6, atol=0), f"step {s}")


def test_lr_schedule_shape():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(po.lr_schedule(cfg, torch.tensor(s)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1e-3) < 1e-9
    assert lrs[-1] < lrs[1]
    assert lrs[-1] >= 0.1 * 1e-3 - 1e-12


@pytest.mark.parametrize("scale", [10.0, 1e-3])
def test_clip_by_global_norm(scale):
    """One leaf in float32 and one in bfloat16, clipped (scale 10) and not
    (1e-3): the norm and each leaf as the reference's."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((7, 5)) * scale).astype(np.float32)
    b = (rng.standard_normal(9) * scale).astype(np.float32)
    want, wnorm = ro.clip_by_global_norm(
        {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16)}, 1.0)
    got, gnorm = po.clip_by_global_norm(
        {"a": torch.from_numpy(a),
         "b": torch.from_numpy(b).to(torch.bfloat16)}, 1.0)
    close(gnorm, wnorm, dict(rtol=1e-6, atol=0))
    close(got["a"], want["a"], dict(rtol=1e-6, atol=0))
    assert got["b"].dtype == torch.bfloat16
    close(got["b"], want["b"], BF16_TOL)


def test_global_norm_clip_values():
    clipped, norm = po.clip_by_global_norm({"a": torch.full((10,), 10.0)},
                                           1.0)
    assert abs(float(norm) - np.sqrt(1000.0)) < 1e-3
    assert abs(float(torch.sqrt(torch.sum(clipped["a"] ** 2))) - 1.0) < 1e-5


# -- the optimizers, step by step ----------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_minimize_quadratic(name):
    cfg = OptimizerConfig(name=name, lr=0.1, warmup_steps=0,
                          total_steps=10000, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5]),
              "b": torch.tensor([[1.0, -1.0], [0.5, 2.0]])}
    state = po.opt_init(cfg, params)
    for _ in range(60):
        grads = {k: v.clone() for k, v in params.items()}
        params, state, m = po.opt_update(cfg, grads, state, params)
    assert sum(float((p * p).sum()) for p in params.values()) < 0.5
    assert np.isfinite(float(m["grad_norm"]))


def test_adafactor_state_is_factored():
    state = po.adafactor_init({"big": torch.zeros(64, 32),
                               "vec": torch.zeros(16)})
    assert state.vr["big"].shape == (64,) and state.vc["big"].shape == (32,)
    assert state.v["big"] is None and state.vr["vec"] is None
    assert state.v["vec"].shape == (16,)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        po.opt_init(OptimizerConfig(name="sgd"), {"w": torch.zeros(2)})


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-4b"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_steps_match_the_reference(arch, name, dtype):
    check_optimizer_steps(arch, name, dtype)


def check_optimizer_steps(arch, name, dtype, check_states=None):
    """Three updates from a zero state on a smoke model's tree (gradients
    large enough to clip on the first), then a fourth from a state carried
    across with opt_state_from_reference: parameters and state as the
    reference's after each (``check_states(got, want, cfg)``, by default
    ``check_state`` at F32_TOL)."""
    if check_states is None:
        check_states = lambda got, want, cfg: check_state(got, want, cfg,
                                                          F32_TOL)
    params, params_np, cfg = ref_tree(arch, dtype)
    rcfg, pcfg = both_cfgs(name=name, lr=1e-2, warmup_steps=1,
                           total_steps=10, weight_decay=0.1)
    rstate = ro.opt_init(rcfg, params)
    port = {k: v.clone() for k, v in to_port(params_np, cfg).items()}
    pstate = po.opt_init(pcfg, port)
    upd = jax.jit(lambda g, s, p: ro.opt_update(rcfg, g, s, p))
    for i in range(3):
        g_np = grads_like(params_np, seed=10 + i, scale=0.5 if i == 0
                          else 0.01)
        params, rstate, rm = upd(jax.tree_util.tree_map(jnp.asarray, g_np),
                                 rstate, params)
        port, pstate, pm = po.opt_update(pcfg, to_port(g_np, cfg), pstate,
                                         port)
        close(pm["grad_norm"], rm["grad_norm"], dict(rtol=1e-5, atol=0))
        close(pm["lr"], rm["lr"], dict(rtol=1e-6, atol=0))
        check_params(port, params, cfg, TOL[dtype])
        check_states(pstate, rstate, cfg)
    # a fourth step from the reference's own state, carried across
    carried = opt_state_from_reference(
        jax.tree_util.tree_map(np.asarray, rstate), cfg)
    check_state(carried, rstate, cfg, dict(rtol=0, atol=0))
    port = {k: v.clone() for k, v in to_port(
        jax.tree_util.tree_map(np.asarray, params), cfg).items()}
    g_np = grads_like(params_np, seed=20, scale=0.01)
    params, rstate, _ = upd(jax.tree_util.tree_map(jnp.asarray, g_np),
                            rstate, params)
    port, carried, _ = po.opt_update(pcfg, to_port(g_np, cfg), carried,
                                     port)
    check_params(port, params, cfg, TOL[dtype])
    check_states(carried, rstate, cfg)


# -- leaves: statistics over the reference's stacked leaves ---------------------

def test_leaf_groups_follow_the_reference_leaves():
    _, params_np, cfg = ref_tree("qwen3-4b", "float32")
    port = to_port(params_np, cfg)
    groups = po.leaf_groups(port)
    assert set(groups) == {k for k, _ in leaf_paths(params_np)}
    assert groups["dense_layers/attn/q_norm"] == [
        f"layers.{i}.attn.q_norm" for i in range(cfg.n_layers)]
    assert groups["embed"] == ["embed"]
    for key, names in groups.items():
        want = dict(leaf_paths(params_np))[key]
        np.testing.assert_array_equal(
            to_np(po.stack_leaf(port, key, names)), want.astype(np.float32))


def test_adafactor_factors_the_stacked_leaves():
    """granite SMOKE (2 layers): the norm scales [L, d] factor into vr [L]
    and vc [d], the weights [L, din, dout] per layer, and the rms clip
    spans both layers, as the reference's; the same update taken block
    by block (per-layer leaves) gives another vc and other parameters."""
    params, params_np, cfg = ref_tree("granite-3-2b", "float32")
    assert cfg.n_layers >= 2
    rcfg, pcfg = both_cfgs(name="adafactor", lr=1e-2, warmup_steps=0,
                           total_steps=10)
    g_np = grads_like(params_np, seed=4)
    # layer 1's gradients far larger than layer 0's: per-layer and
    # stacked statistics part ways
    g_np["dense_layers"] = jax.tree_util.tree_map(
        lambda g: g * np.asarray([1.0, 40.0], np.float32).reshape(
            (2,) + (1,) * (g.ndim - 1)), g_np["dense_layers"])
    rstate = ro.adafactor_init(params)
    rnew, rstate, _ = jax.jit(
        lambda g, s, p: ro.adafactor_update(rcfg, g, s, p))(
        jax.tree_util.tree_map(jnp.asarray, g_np), rstate, params)
    port = {k: v.clone() for k, v in to_port(params_np, cfg).items()}
    pstate = po.adafactor_init(port)
    assert tuple(pstate.vr["dense_layers/ln1"].shape) == (2,)
    assert tuple(pstate.vc["dense_layers/ln1"].shape) == (cfg.d_model,)
    assert tuple(pstate.vr["dense_layers/attn/wq"].shape) == (2, cfg.d_model)
    port, pstate, _ = po.adafactor_update(pcfg, to_port(g_np, cfg), pstate,
                                          port)
    check_state(pstate, rstate, cfg, F32_TOL)
    check_params(port, rnew, cfg, F32_TOL)
    # block by block (what the port would compute without the grouping)
    blockwise = {k: v.clone() for k, v in to_port(params_np, cfg).items()}
    bstate = po.adafactor_init(
        {k.replace(".", "_"): v for k, v in blockwise.items()})
    renamed = {k.replace(".", "_"): v for k, v in blockwise.items()}
    po.adafactor_update(pcfg, {k.replace(".", "_"): v for k, v in
                               to_port(g_np, cfg).items()}, bstate, renamed)
    assert bstate.vr["layers_0_ln1"] is None      # a 1-d leaf: not factored
    assert not torch.allclose(renamed["layers_0_attn_wq"],
                              port["layers.0.attn.wq"], rtol=1e-4, atol=0)


def test_compression_scales_span_the_stacked_leaf():
    """One int8 scale per reference leaf (max over both layers); the
    dequantized gradients and the residuals as the reference's, and
    different from per-layer scales."""
    _, params_np, cfg = ref_tree("granite-3-2b", "float32")
    g_np = grads_like(params_np, seed=5)
    g_np["dense_layers"] = jax.tree_util.tree_map(
        lambda g: g * np.asarray([1.0, 9.0], np.float32).reshape(
            (2,) + (1,) * (g.ndim - 1)), g_np["dense_layers"])
    ef_np = grads_like(params_np, seed=6, scale=1e-3)
    rq, rs, ref_ef = jax.jit(rc.compress_with_feedback)(
        jax.tree_util.tree_map(jnp.asarray, g_np),
        jax.tree_util.tree_map(jnp.asarray, ef_np))
    q, s, ef = pc.compress_with_feedback(to_port(g_np, cfg),
                                         to_port(ef_np, cfg))
    scales = dict(leaf_paths(jax.tree_util.tree_map(np.asarray, rs)))
    leaf_of = {n: key for key, names in po.leaf_groups(q).items()
               for n in names}
    want_q = to_port(jax.tree_util.tree_map(np.asarray, rq), cfg)
    want_ef = to_port(jax.tree_util.tree_map(np.asarray, ref_ef), cfg)
    for n in q:
        close(s[n], scales[leaf_of[n]], dict(rtol=1e-6, atol=0), n)
        assert q[n].dtype == torch.int8
        # a value an ulp from a rounding boundary may round the other way
        assert (q[n].to(torch.int16) - want_q[n].to(torch.int16)).abs() \
            .max() <= 1, n
        assert (q[n] == want_q[n]).float().mean() > 0.999, n
        # what is sent plus the residual is the same sum either way
        close(pc.dequantize(q[n], s[n]) + ef[n],
              to_np(want_q[n]) * scales[leaf_of[n]] + to_np(want_ef[n]),
              F32_TOL, n)
    per_layer = float(pc.quantize(to_port(g_np, cfg)[
        "layers.0.attn.wq"])[1])
    assert per_layer < 0.5 * float(s["layers.0.attn.wq"])


# -- compression ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize(dtype):
    g = np.random.default_rng(0).standard_normal(1000).astype(np.float32) * 5
    rq, rs = rc.quantize(jnp.asarray(g, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    q, s = pc.quantize(tg)
    close(s, rs, dict(rtol=1e-6, atol=0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    err = (pc.dequantize(q, s) - tg.float()).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6
    close(pc.dequantize(q, s), rc.dequantize(rq, rs), F32_TOL)


def test_error_feedback_matches_and_preserves_sum():
    """50 rounds with error feedback: the port's stream equals the
    reference's, and what was sent plus the residual is the true sum."""
    rng = np.random.default_rng(1)
    grads_seq = [(rng.standard_normal(64) * 0.01).astype(np.float32)
                 for _ in range(50)]
    ref_ef = rc.ef_init({"w": jnp.zeros(64)})
    ef = pc.ef_init({"w": torch.zeros(64)})
    sent = np.zeros(64)
    for g in grads_seq:
        rq, rs, ref_ef = rc.compress_with_feedback({"w": jnp.asarray(g)},
                                                   ref_ef)
        q, s, ef = pc.compress_with_feedback({"w": torch.from_numpy(g)}, ef)
        np.testing.assert_array_equal(q["w"].numpy(), np.asarray(rq["w"]))
        close(ef["w"], ref_ef["w"], dict(rtol=1e-5, atol=1e-8))
        sent += to_np(pc.dequantize(q["w"], s["w"]))
    np.testing.assert_allclose(sent + to_np(ef["w"]), sum(grads_seq),
                               rtol=1e-4, atol=1e-5)
