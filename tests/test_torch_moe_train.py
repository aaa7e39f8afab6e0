"""Port: the MoE family's training half against the reference on the CPU —
the optimizer's and the compression's statistics over the ``moe_layers``
leaves, ``make_train_step``, ``TrainLoop`` with checkpoints and
``launch.train``, at deepseek-v3-671b and grok-1-314b ``SMOKE``.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; gradients are drawn from numpy
seeds; the batches are the pipelines' own. The checks are those of the
dense family's tests, with their tolerances, except where a bullet says
otherwise:
* leaves: ``leaf_groups`` keys equal to the reference's leaf paths, every
  stacked leaf bit-equal; Adafactor's state shapes equal;
* ``opt_update`` (``test_torch_optim.check_optimizer_steps``): float32
  rtol 1e-5 / atol 1e-6 on parameters and state, bfloat16 parameters
  atol = rtol = 2^-7. The bfloat16 state: at most BF16_STATE_FLIPS of a
  field's elements outside rtol 1e-5 / atol 1e-6, each within 2^-7 of the
  field's largest magnitude. The reference's sum of squares over bf16
  gradients (XLA's fused convert and reduce) lies 1e-6 off the float64
  value, the port's within 1e-8; so the clip scales differ and a clipped
  bf16 gradient can round to the neighbouring value (measured at grok
  with AdamW, on the fourth step: 549 of 185,152 moments and 1,705
  master weights outside, the largest 0.23 % of the field's magnitude;
  with the reference's norm given to the port, none);
* the compression: scales rtol 1e-6, int8 values at most one quantum
  apart, what is sent plus the residual rtol 1e-5 / atol 1e-6;
* routes on the first batch: equal in float32; in bfloat16 at most
  ROUTE_FLIPS of the top-k slots apart (measured: 6 of 256 at deepseek,
  none at grok);
* ``make_train_step`` over 3 steps (``test_torch_train.check_train_step``):
  float32 losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-5 (with
  compression at most 2e-3 of the elements outside, none by more than 2^-8
  of the leaf's largest magnitude plus 2 x lr per step); bfloat16 losses
  atol 2e-2, parameters within one bf16 ulp but for at most 10 % of the
  elements; optimizer state within 1e-3 (float32) / 0.1 (bfloat16) of the
  reference's by the norm of the difference. Two cases differ: deepseek
  with AdamW in float32 may have MOE_F32_FLIPS of its elements outside the
  tight tolerance, within the bound (measured: 3 of 274,240, the largest
  1.9e-5 against 1.1e-5: AdamW's normalization magnifies the two
  frameworks' last-bit differences where a gradient is tiny); deepseek
  with Adafactor in bfloat16, whose routes part on the first batch (the
  6 slots above), holds its parameters' update over the three steps
  within ROUTED_UPDATE_RTOL of the reference's by the norm of the
  difference (measured 0.272; 0.064 at grok, 0.066 at granite, whose
  routes do not part), its losses and state as the rest;
* ``TrainLoop``: losses rtol 1e-5, the same skips, final step and
  checkpoints; the port resumed from its own checkpoint equals its
  uninterrupted run exactly (the CPU is deterministic);
* Adafactor taken one slice at a time against the whole-leaf form (the
  reference's, written here with torch): parameters and state within
  SLICE_RTOL relative (the rms over the leaf sums its slices in another
  order).
torch is pinned to one thread, as in ``test_torch_train.py``.
"""
import functools
import io
import os
from contextlib import redirect_stdout
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import build_model as ref_build
from repro.models import moe as RM
from repro.optim import compression as rc
from repro.optim import optimizer as ro
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import OptimizerConfig
from repro_torch.configs import SMOKES
from repro_torch.convert import (leaf_paths, model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import moe as PM
from repro_torch.optim import compression as pc
from repro_torch.optim import optimizer as po

import test_torch_optim as topt
import test_torch_train as ttrain

MOE_ARCHS = ("deepseek-v3-671b", "grok-1-314b")
N_LEAVES = {"deepseek-v3-671b": 45, "grok-1-314b": 13}
SLICE_RTOL = 1e-6
BF16_STATE_FLIPS = 2e-2
ROUTE_FLIPS = 0.05
MOE_F32_FLIPS = 2e-3
ROUTED_UPDATE_RTOL = 0.35


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at smoke shapes torch's threads buy nothing,
    and under the suite's parallel workers they contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- leaves -------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_leaf_groups_are_the_reference_leaves(arch):
    """Both stacks map onto the reference's two prefixes, each stack's
    layers in order; ``mtp`` stays unstacked; every leaf stacks to the
    reference's array."""
    _, params_np, cfg = topt.ref_tree(arch, "float32")
    port = topt.to_port(params_np, cfg)
    groups = po.leaf_groups(port)
    want = dict(leaf_paths(params_np))
    assert set(groups) == set(want) and len(groups) == N_LEAVES[arch]
    n_dense = cfg.moe.first_dense
    assert groups["moe_layers/ffn/gate"] == [
        f"moe_layers.{j}.ffn.gate" for j in range(cfg.n_layers - n_dense)]
    if n_dense:
        assert groups["dense_layers/ffn/gate"] == [
            f"layers.{i}.ffn.gate" for i in range(n_dense)]
    if cfg.mtp:
        assert groups["mtp/proj"] == ["mtp.proj"]
        assert groups["mtp/layer/attn/wq_a"] == ["mtp.layer.attn.wq_a"]
        assert not po.is_stacked("mtp/layer/attn/wq_a")
    for key, names in groups.items():
        np.testing.assert_array_equal(
            topt.to_np(po.stack_leaf(port, key, names)),
            want[key].astype(np.float32), err_msg=key)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_adafactor_state_shapes_are_the_reference(arch):
    """An expert weight [L, E, d, f] factors into vr [L, E, d] and vc
    [L, E, f]; the float32 router [L, d, E] as any rank-2+ leaf."""
    params, params_np, cfg = topt.ref_tree(arch, "float32")
    want = jax.eval_shape(ro.adafactor_init, params)
    got = po.adafactor_init(topt.to_port(params_np, cfg))
    m = cfg.moe
    n_moe = cfg.n_layers - m.first_dense
    assert tuple(got.vr["moe_layers/ffn/gate"].shape) == (
        n_moe, m.n_experts, cfg.d_model)
    assert tuple(got.vc["moe_layers/ffn/gate"].shape) == (
        n_moe, m.n_experts, m.d_expert)
    assert tuple(got.vc["moe_layers/ffn/router"].shape) == (
        n_moe, m.n_experts)
    for field in ("vr", "vc", "v"):
        w = dict(leaf_paths(getattr(want, field)))
        g = getattr(got, field)
        assert g.keys() == w.keys(), field
        for k, s in w.items():
            assert (g[k] is None) == (s is None), (field, k)
            if s is not None:
                assert tuple(g[k].shape) == s.shape, (field, k)


def state_with_flips(got, want, cfg):
    """The optimizer state against the reference's at F32_TOL, but for at
    most BF16_STATE_FLIPS of each field's elements, each within 2^-7 of
    the field's largest magnitude (a bf16 gradient clipped to the
    neighbouring bf16 value: see the module docstring)."""
    assert int(got.step) == int(want.step)
    want_np = jax.tree_util.tree_map(np.asarray, want)
    for field in got._fields[1:]:
        if isinstance(got, po.AdamWState):
            w = topt.to_port(getattr(want_np, field), cfg)
        else:
            w = {k: a for k, a in leaf_paths(getattr(want_np, field))
                 if a is not None}
        g = getattr(got, field)
        a = np.concatenate([topt.to_np(g[k]).ravel() for k in w])
        b = np.concatenate([topt.to_np(w[k]).ravel() for k in w])
        diff = np.abs(a - b)
        outside = diff > topt.F32_TOL["atol"] + topt.F32_TOL["rtol"] \
            * np.abs(b)
        assert outside.sum() <= BF16_STATE_FLIPS * b.size, field
        assert diff.max() <= 2 ** -7 * np.abs(b).max(), field


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_steps_match_the_reference(arch, name, dtype):
    topt.check_optimizer_steps(
        arch, name, dtype,
        check_states=state_with_flips if dtype == "bfloat16" else None)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_from_reference(arch, name):
    """A reference state after one update crosses bit for bit, keyed as
    the port's own state (AdamW by parameter name, Adafactor by
    ``leaf_groups`` key)."""
    params, params_np, cfg = topt.ref_tree(arch, "float32")
    rcfg, pcfg = topt.both_cfgs(name=name, lr=1e-2, warmup_steps=0,
                                total_steps=10)
    g = jax.tree_util.tree_map(jnp.asarray,
                               topt.grads_like(params_np, seed=30))
    _, rstate, _ = jax.jit(lambda g, s, p: ro.opt_update(rcfg, g, s, p))(
        g, ro.opt_init(rcfg, params), params)
    got = opt_state_from_reference(
        jax.tree_util.tree_map(np.asarray, rstate), cfg)
    own = po.opt_init(pcfg, topt.to_port(params_np, cfg))
    for field in own._fields[1:]:
        assert getattr(got, field).keys() == getattr(own, field).keys()
    if name == "adafactor":
        assert set(got.vr) == set(po.leaf_groups(topt.to_port(params_np,
                                                               cfg)))
    topt.check_state(got, rstate, cfg, dict(rtol=0, atol=0))


def test_compression_scale_spans_the_moe_leaf():
    """grok SMOKE: an expert weight's int8 scale is the max over both
    layers and all experts (one expert of layer 1 is 9x the rest), as the
    reference's over its stacked leaf; the dequantized gradients and the
    residuals as the reference's."""
    _, params_np, cfg = topt.ref_tree("grok-1-314b", "float32")
    g_np = topt.grads_like(params_np, seed=5)
    boost = np.ones((cfg.n_layers, cfg.moe.n_experts, 1, 1), np.float32)
    boost[1, 2] = 9.0
    for w in ("gate", "up", "down"):
        g_np["moe_layers"]["ffn"][w] = g_np["moe_layers"]["ffn"][w] * boost
    ef_np = topt.grads_like(params_np, seed=6, scale=1e-3)
    rq, rs, ref_ef = jax.jit(rc.compress_with_feedback)(
        jax.tree_util.tree_map(jnp.asarray, g_np),
        jax.tree_util.tree_map(jnp.asarray, ef_np))
    q, s, ef = pc.compress_with_feedback(topt.to_port(g_np, cfg),
                                         topt.to_port(ef_np, cfg))
    scales = dict(leaf_paths(jax.tree_util.tree_map(np.asarray, rs)))
    leaf_of = {n: key for key, names in po.leaf_groups(q).items()
               for n in names}
    want_q = topt.to_port(jax.tree_util.tree_map(np.asarray, rq), cfg)
    want_ef = topt.to_port(jax.tree_util.tree_map(np.asarray, ref_ef), cfg)
    for n in q:
        topt.close(s[n], scales[leaf_of[n]], dict(rtol=1e-6, atol=0), n)
        assert (q[n].to(torch.int16) - want_q[n].to(torch.int16)).abs() \
            .max() <= 1, n
        topt.close(pc.dequantize(q[n], s[n]) + ef[n],
                   topt.to_np(want_q[n]) * scales[leaf_of[n]]
                   + topt.to_np(want_ef[n]), topt.F32_TOL, n)
    assert s["moe_layers.0.ffn.gate"] is s["moe_layers.1.ffn.gate"]
    layer0 = float(pc.quantize(topt.to_port(g_np, cfg)[
        "moe_layers.0.ffn.gate"])[1])
    assert layer0 < 0.5 * float(s["moe_layers.0.ffn.gate"])


# -- Adafactor one slice at a time ------------------------------------------------

@torch.no_grad()
def whole_leaf_adafactor(cfg, grads, state, params):
    """Adafactor over each whole stacked leaf at once: the reference's
    ``adafactor_update`` in torch, the form the sliced update replaces."""
    gnorm = po.global_norm(grads)
    scale = po._clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = po.lr_schedule(cfg, step)
    decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8
    eps = 1e-30
    for key, names in po.leaf_groups(params).items():
        gf = po.stack_leaf({n: po._clipped(grads[n], scale) for n in names},
                           key, names).float()
        g2 = gf * gf + eps
        if gf.dim() >= 2:
            vr, vc = state.vr[key], state.vc[key]
            vr.copy_(decay * vr + (1 - decay) * g2.mean(dim=-1))
            vc.copy_(decay * vc + (1 - decay) * g2.mean(dim=-2))
            row = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            precond = gf / (row.sqrt()[..., None] * vc.sqrt()[..., None, :]
                            + 1e-9)
        else:
            v = state.v[key]
            v.copy_(decay * v + (1 - decay) * g2)
            precond = gf / (v.sqrt() + 1e-9)
        rms = torch.sqrt(torch.mean(precond * precond) + eps)
        precond = precond / torch.clamp(rms, min=1.0)
        pf = po.stack_leaf(params, key, names).float()
        p_new = pf - lr * precond - lr * cfg.weight_decay * pf
        if po.is_stacked(key):
            for i, n in enumerate(names):
                params[n].copy_(p_new[i])
        else:
            params[names[0]].copy_(p_new)
    return params, state._replace(step=step)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sliced_adafactor_equals_the_whole_leaf(arch):
    """Three float32 updates with gradients that differ by layer and by
    expert (so that the rms clip binds and per-slice statistics would
    differ): parameters and vr / vc / v within SLICE_RTOL."""
    _, params_np, cfg = topt.ref_tree(arch, "float32")
    ocfg = OptimizerConfig(name="adafactor", lr=1e-2, warmup_steps=0,
                           total_steps=10, weight_decay=0.1)
    sliced = {k: v.clone() for k, v in topt.to_port(params_np,
                                                    cfg).items()}
    whole = {k: v.clone() for k, v in sliced.items()}
    s_state, w_state = po.adafactor_init(sliced), po.adafactor_init(whole)
    rng = np.random.default_rng(7)
    for i in range(3):
        grads = {}
        for k, p in sliced.items():
            g = rng.standard_normal(tuple(p.shape)).astype(np.float32)
            if p.dim() == 3:            # an expert weight: one expert 30x
                g[rng.integers(p.shape[0])] *= 30.0
            if ".1." in k:              # layer 1 of a stack: 10x
                g *= 10.0
            grads[k] = torch.from_numpy(g * (0.5 if i == 0 else 0.01))
        po.adafactor_update(ocfg, grads, s_state, sliced)
        whole_leaf_adafactor(ocfg, grads, w_state, whole)
    for k in whole:
        assert rel_err(sliced[k], whole[k]) <= SLICE_RTOL, k
    for field in ("vr", "vc", "v"):
        for k, w in getattr(w_state, field).items():
            g = getattr(s_state, field)[k]
            assert (g is None) == (w is None), (field, k)
            if w is not None:
                assert rel_err(g, w) <= SLICE_RTOL, (field, k)


# -- make_train_step --------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routes_match_the_reference(arch, dtype, monkeypatch):
    """The top-k expert ids of every MoE layer on the pipeline's first
    batch, the reference's read through a callback on its ``_route``:
    equal in float32; in bfloat16 at most ROUTE_FLIPS of the slots apart
    (the hidden states reach the float32 router rounded to bf16 in
    another order; measured: 6 of 256 slots at deepseek, 0 at grok)."""
    ref_ids, port_ids = [], []
    route = RM._route

    def hooked(params, cfg, x_flat):
        out = route(params, cfg, x_flat)
        jax.debug.callback(lambda i: ref_ids.append(np.asarray(i)), out[1])
        return out
    monkeypatch.setattr(RM, "_route", hooked)
    _, run = ttrain.runs(arch, dtype)
    tokens = TokenPipeline(run.model, run.shape).batch(0)["tokens"]
    ref = ref_build(replace(REF_SMOKES[arch], dtype=dtype))
    jax.block_until_ready(ref.forward(jax.tree_util.tree_map(
        jnp.asarray, ttrain.ref_params(arch, dtype)), jnp.asarray(tokens)))
    model = build_model(run.model, device="cpu")
    ttrain.load_reference_weights(model, arch, dtype)
    hooks = [b.ffn.register_forward_pre_hook(
        lambda mod, args: port_ids.append(
            PM._route(mod.params(), mod.cfg, args[0])[1].numpy()))
        for b in model.moe_layers]
    model.forward(torch.from_numpy(tokens))
    for h in hooks:
        h.remove()
    # the reference routes each sequence on its own (vmap): one callback
    # a sequence, layer by layer
    want = np.stack(ref_ids).reshape((len(port_ids),) + port_ids[0].shape)
    got = np.stack(port_ids)
    differ = int((got != want).sum())
    if dtype == "float32":
        assert differ == 0
    else:
        assert differ <= ROUTE_FLIPS * got.size, differ


def update_check(arch, dtype):
    """The parameters' update over the three steps (the parameters less
    the initial weights) within ROUTED_UPDATE_RTOL of the reference's by
    the norm of the difference, for a bf16 case whose routes part (see
    the module docstring)."""
    initial = model_params_from_reference(ttrain.ref_params(arch, dtype),
                                          SMOKES[arch])

    def check(got, want, **_):
        delta = lambda t: np.concatenate([
            (topt.to_np(t[k]) - topt.to_np(initial[k])).ravel()
            for k in want])
        a, b = delta(got), delta(want)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= ROUTED_UPDATE_RTOL, rel
    return check


STEP_CASES = [
    # (arch, optimizer, microbatches, compress, dtype), the parameter
    # check: each arch with each optimizer, each in float32 and bfloat16,
    # one and two microbatches
    (("deepseek-v3-671b", "adamw", 1, False, "float32"),
     functools.partial(ttrain.param_check, flips=MOE_F32_FLIPS)),
    (("grok-1-314b", "adafactor", 2, True, "float32"), ttrain.param_check),
    (("deepseek-v3-671b", "adafactor", 1, True, "bfloat16"),
     update_check("deepseek-v3-671b", "bfloat16")),
    (("grok-1-314b", "adamw", 2, False, "bfloat16"), ttrain.param_check),
]


@pytest.mark.parametrize("case,check", [
    pytest.param(case, check, id="-".join(str(x) for x in case))
    for case, check in STEP_CASES])
def test_train_step_matches_the_reference(case, check):
    ttrain.check_train_step(case, check_params=check)


# -- TrainLoop and the launcher ------------------------------------------------------

def test_train_loop_with_checkpointing_matches_the_reference(tmp_path):
    """deepseek SMOKE with Adafactor: a NaN on call 1 is skipped in both
    packages; the losses, skips, final step and checkpoints are the
    reference's; the Adafactor state's leaf keys round-trip through the
    checkpoint's paths."""
    ref, port = ttrain.loops(tmp_path, arch="deepseek-v3-671b",
                             optimizer="adafactor")
    ttrain.poison(ref, {1}, port=False)
    ttrain.poison(port, {1}, port=True)
    want, got = ttrain.run_both(ref, port)
    ttrain.same_result(got, want)
    assert (got.skipped_steps, got.final_step, len(got.losses)) == (1, 6, 5)
    assert port.ckpt.all_steps() == ref.ckpt.all_steps() == [2, 4, 6]
    params = dict(port.ts.model.named_parameters())
    opt = po.opt_init(port.run.optimizer, params)
    tree, meta = CheckpointManager(port.ckpt.root).restore(
        {"params": params, "opt": opt})
    assert meta["step"] == 6 and tree["opt"].vr.keys() == opt.vr.keys()
    assert "moe_layers/ffn/gate" in tree["opt"].vr
    assert int(tree["opt"].step) == 5


def test_train_loop_resume(tmp_path):
    """deepseek SMOKE: a run stopped at step 3 and resumed to 6 equals the
    uninterrupted run's last three steps."""
    kw = dict(arch="deepseek-v3-671b", optimizer="adafactor", ckpt_every=3)
    _, full = ttrain.loops(tmp_path, steps=6, tag="-full", **kw)
    whole = full.run_loop()
    _, first = ttrain.loops(tmp_path, steps=3, total_steps=6, tag="-split",
                            **kw)
    first.run_loop()
    _, second = ttrain.loops(tmp_path, steps=6, tag="-split", **kw)
    rest = second.run_loop(resume=True)
    assert rest.final_step == 6
    assert rest.losses == whole.losses[3:]


def test_launch_train_grok_smoke_on_the_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--arch", "grok-1-314b", "--smoke", "--steps", "4",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu", "--optimizer", "adafactor"]
    with redirect_stdout(out):
        assert launch_train.main(argv) == 0
    assert "done at step 4 on cpu" in out.getvalue()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    with redirect_stdout(out):
        assert launch_train.main(argv + ["--resume"]) == 0
    assert "no step left to run" in out.getvalue()
