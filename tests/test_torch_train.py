"""Port: the dense LM's training half against the reference on the CPU —
the data pipelines, ``TransformerLM.loss``, ``make_train_step``,
``TrainLoop`` with checkpoints, and the two entry points.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; the batches are the pipelines'
own (bit-equal in both packages). Tolerances:
* pipelines: bit-equal;
* ``loss``: float32 rtol 1e-5, bfloat16 atol 2e-2 (the logits' bf16
  tolerance of ``tests/test_torch_models.py``);
* train steps, float32: each step's loss rtol 1e-5; parameters rtol 1e-4
  / atol 1e-5. The int8 compression rounds ``g / scale`` to the nearest
  integer, so an element whose float32 gradient differs by an ulp across
  the two frameworks can land one quantum apart; there the update
  differs by up to the learning rate, so with ``compress_grads`` at
  most ``COMPRESS_FLIPS`` of the elements may exceed the tight tolerance,
  and none by more than 2 x lr per step (measured: without compression
  every element within, the largest difference 7.9e-6; with it 82 of
  156k elements outside, the largest 6.2e-4, on qwen3 with Adafactor);
* train steps, bfloat16: losses atol 2e-2; parameters within one bf16
  ulp of the reference's but for at most ``BF16_FLIPS`` of the elements,
  and none by more than 2^-8 of its leaf's largest magnitude plus 2 x lr
  per step (an element whose bf16 gradient rounds the other way moves by up
  to lr under AdamW; measured: 4.9 % of the elements outside one ulp on
  granite with Adafactor, 2.9 % on qwen3 with AdamW, the largest
  difference 2.44e-3; a step that skipped the update leaves 69 % and
  76 % outside);
* optimizer state after the three steps (AdamW's ``m``, ``v`` and its
  float32 ``master`` less the initial weights; Adafactor's ``vr``,
  ``vc``, ``v``), carried over with ``convert.opt_state_from_reference``:
  the norm of the difference at most ``STATE_RTOL`` of the reference's
  norm (measured at most 1.1e-4 in float32, 0.058 in bfloat16, where
  no update gives 1);
* ``TrainLoop``: the reference's losses rtol 1e-5, the same skips,
  rewinds, final step and checkpoints; the port resumed from its own
  checkpoint equals its uninterrupted run exactly (the CPU is
  deterministic).
"""
import importlib.util
import io
import json
import os
import pathlib
import signal
from contextlib import redirect_stdout
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MeshConfig as RefMeshConfig
from repro.config import OptimizerConfig as RefOptimizerConfig
from repro.config import RunConfig as RefRunConfig
from repro.configs import SMOKES as REF_SMOKES
from repro.data.pipeline import QueryPipeline as RefQueryPipeline
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.launch.mesh import make_local_mesh
from repro.models import build_model as ref_build
from repro.models.transformer import _xent as ref_xent
from repro.optim.compression import ef_init as ref_ef_init
from repro.optim.optimizer import opt_init as ref_opt_init
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro.runtime.train_loop import TrainLoop as RefTrainLoop
from repro.runtime.train_loop import TrainLoopConfig as RefLoopConfig
from repro_torch import train_lm
from repro_torch.config import MeshConfig, OptimizerConfig, RunConfig
from repro_torch.configs import SMOKES
from repro_torch.configs.pir import PIR_CONFIGS
from repro_torch.configs.shapes import SMOKE_TRAIN
from repro_torch.convert import (model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.data.pipeline import QueryPipeline, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.transformer import _xent
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = dict(shape=(1, 1), axes=("data", "model"))
COMPRESS_FLIPS = 2e-3
BF16_FLIPS = 0.1
STATE_RTOL = {"float32": 1e-3, "bfloat16": 0.1}



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


def runs(arch, dtype, *, shape=SMOKE_TRAIN, **kw):
    """The same RunConfig in both packages."""
    opt = kw.pop("optimizer", {})
    ref = RefRunConfig(model=replace(REF_SMOKES[arch], dtype=dtype),
                       shape=shape, mesh=RefMeshConfig(**MESH),
                       optimizer=RefOptimizerConfig(**opt), **kw)
    port = RunConfig(model=replace(SMOKES[arch], dtype=dtype), shape=shape,
                     mesh=MeshConfig(**MESH),
                     optimizer=OptimizerConfig(**opt), **kw)
    assert ref.to_dict() == port.to_dict()
    return ref, port


_PARAMS = {}


def ref_params(arch, dtype):
    """The reference's smoke weights from PRNGKey(0), as numpy."""
    if (arch, dtype) not in _PARAMS:
        model = ref_build(replace(REF_SMOKES[arch], dtype=dtype))
        _PARAMS[arch, dtype] = jax.tree_util.tree_map(
            np.asarray, model.init_params(jax.random.PRNGKey(0)))
    return _PARAMS[arch, dtype]


def load_reference_weights(model, arch, dtype):
    """Load the reference's smoke weights into the port's model (whose
    train step's ``init_state(None)`` then starts from them)."""
    model.load_state_dict(model_params_from_reference(
        ref_params(arch, dtype), model.cfg))


# -- pipelines ------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_token_pipeline_batches_equal_the_reference(family):
    extra = {"vlm": dict(n_frontend_tokens=4),
             "audio": dict(encoder_len=6)}.get(family, {})
    ref_cfg = replace(REF_SMOKES["granite-3-2b"], family=family, **extra)
    cfg = replace(SMOKES["granite-3-2b"], family=family, **extra)
    shape = replace(SMOKE_TRAIN, global_batch=8, seq_len=16)
    for seed, hosts in ((0, 1), (1, 4)):
        for host in range(hosts):
            ref = RefTokenPipeline(ref_cfg, shape, seed=seed,
                                   process_index=host, num_processes=hosts)
            port = TokenPipeline(cfg, shape, seed=seed, process_index=host,
                                 num_processes=hosts)
            for step in (0, 1, 7):
                want, got = ref.batch(step), port.batch(step)
                assert want.keys() == got.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="not divisible"):
        TokenPipeline(cfg, shape, num_processes=3)


def test_query_pipeline_equals_the_reference():
    for seed in (0, 3):
        ref = RefQueryPipeline(n_items=1 << 10, batch=32, seed=seed)
        port = QueryPipeline(n_items=1 << 10, batch=32, seed=seed)
        for step in (0, 5):
            np.testing.assert_array_equal(port.indices(step),
                                          ref.indices(step))


# -- the loss -------------------------------------------------------------------

def test_xent_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    tgt = rng.integers(0, 50, (2, 7))
    got = _xent(torch.from_numpy(logits), torch.from_numpy(tgt))
    want = ref_xent(jnp.asarray(logits), jnp.asarray(tgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-4b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_the_reference(arch, dtype):
    rcfg, cfg = (replace(REF_SMOKES[arch], dtype=dtype),
                 replace(SMOKES[arch], dtype=dtype))
    ref = ref_build(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, ref_params(arch, dtype))
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 33)) \
        .astype(np.int32)
    want, wm = jax.jit(ref.loss)(params, tok)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(model_params_from_reference(ref_params(arch, dtype),
                                                     cfg))
    got, gm = port.loss(torch.from_numpy(tok))
    tol = dict(rtol=1e-5, atol=0) if dtype == "float32" else \
        dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(float(got), float(want), **tol)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **tol)
    assert float(gm["aux"]) == 0.0 == float(wm["aux"])


def test_remat_keeps_the_loss_and_gradients():
    """remat="block" recomputes each block in the backward pass: the same
    loss and gradients as remat="none", bit for bit on the CPU; the serve
    entry points record no graph either way."""
    cfg = replace(SMOKES["qwen3-4b"], dtype="float32")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 32)))
    out = {}
    for remat in ("none", "block"):
        model = build_model(cfg, device="cpu", remat=remat).init_params(
            torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        loss, _ = model.loss(tok)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[remat] = (loss.detach(), grads)
        logits, _ = model.forward(tok)
        assert not logits.requires_grad
    assert torch.equal(out["none"][0], out["block"][0])
    for a, b in zip(out["none"][1], out["block"][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown remat"):
        build_model(cfg, device="cpu", remat="full")


def test_serve_model_parameters_need_no_grad():
    model = build_model(SMOKES["granite-3-2b"], device="cpu")
    assert not any(p.requires_grad for p in model.parameters())


# -- make_train_step ------------------------------------------------------------

STEP_CASES = [
    # (arch, optimizer, microbatches, compress, dtype): each arch with each
    # optimizer, each in float32 and bfloat16, one and two microbatches,
    # compression on three of the four
    ("granite-3-2b", "adamw", 1, False, "float32"),
    ("qwen3-4b", "adafactor", 2, True, "float32"),
    ("granite-3-2b", "adafactor", 1, True, "bfloat16"),
    ("qwen3-4b", "adamw", 2, True, "bfloat16"),
]
LR = 1e-3


def bf16_ulp(w: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 (8 significant bits) at |w|."""
    a = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def param_check(got: dict, want: dict, *, dtype, compress, steps,
                flips=None):
    """(outliers, max |diff|) under the module docstring's tolerances;
    ``flips`` overrides the share of float32 elements that may lie outside
    the tight tolerance (within the bound)."""
    worst, outliers, total = 0.0, 0, 0
    for k, w in want.items():
        g, w = to_np(got[k]), to_np(w)
        diff = np.abs(g - w)
        worst = max(worst, float(diff.max()))
        if dtype == "float32":
            tight = diff <= 1e-5 + 1e-4 * np.abs(w)
        else:
            tight = diff <= bf16_ulp(w)
        outliers += int((~tight).sum())
        total += diff.size
        assert diff.max() <= 2 ** -8 * np.abs(w).max() + 2 * LR * steps, k
    if dtype == "bfloat16":
        assert outliers <= BF16_FLIPS * total, (outliers, total)
    elif flips is not None:
        assert outliers <= flips * total, (outliers, total)
    elif compress:
        assert outliers <= COMPRESS_FLIPS * total, (outliers, total)
    else:
        assert outliers == 0, (outliers, total)
    return outliers, worst


def state_check(got, want, initial: dict, *, dtype):
    """Each field of the optimizer state against the reference's, by the
    norm of the difference over the reference's norm; AdamW's master less
    the initial weights (its update)."""
    for f in want._fields[1:]:
        g, w = getattr(got, f), getattr(want, f)
        assert g.keys() == w.keys(), f
        keys = [k for k in w if w[k] is not None]
        assert all(g[k] is None for k in w if w[k] is None), f
        a = np.concatenate([to_np(g[k]).ravel() for k in keys])
        b = np.concatenate([to_np(w[k]).ravel() for k in keys])
        if f == "master":
            z = np.concatenate([to_np(initial[k]).ravel() for k in keys])
            a, b = a - z, b - z
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= STATE_RTOL[dtype], (f, rel)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_train_step_matches_the_reference(case):
    check_train_step(case)


def check_train_step(case, check_params=param_check):
    """Three steps of ``case`` (arch, optimizer, microbatches, compress,
    dtype) in both packages from the reference's weights: losses, the
    schedule, parameters (``check_params``) and optimizer state under the
    module docstring's tolerances."""
    arch, name, micro, compress, dtype = case
    ref_run, run = runs(arch, dtype, microbatches=micro, optimizer=dict(
        name=name, lr=LR, warmup_steps=1, total_steps=10,
        compress_grads=compress))
    mesh = make_local_mesh()
    with mesh:
        rts = ref_make_train_step(ref_run, mesh)
    fresh = lambda: jax.tree_util.tree_map(jnp.array,
                                           ref_params(arch, dtype))
    rparams = fresh()
    # its own buffers: the step donates params and state (an f32 master
    # made by astype would alias the params)
    ropt = ref_opt_init(ref_run.optimizer, fresh())
    ref_ef = ref_ef_init(rparams) if compress else None
    ts = make_train_step(run, device="cpu")
    load_reference_weights(ts.model, arch, dtype)
    params, opt, ef = ts.init_state(None)
    assert (ef is None) == (not compress) == (ref_ef is None)
    assert {k: s.shape for k, s in ts.input_structs.items()} == \
        {k: s.shape for k, s in rts.input_structs.items()}
    pipe = TokenPipeline(run.model, run.shape)
    for step in range(3):
        # every input the step takes (a VLM's prefix_embeds too), split
        # into microbatches as the step's structs say
        batch = {k: v.reshape(ts.input_structs[k].shape)
                 for k, v in pipe.batch(step).items()}
        with mesh:
            rparams, ropt, ref_ef, rm = rts.step(
                rparams, ropt, ref_ef,
                {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, ef, m = ts.step(params, opt, ef, batch)
        if dtype == "float32":
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       atol=2e-2)
    assert int(opt.step) == 3 == int(ropt.step)
    want = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), run.model)
    check_params(params, want, dtype=dtype, compress=compress, steps=3)
    state_check(opt, opt_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ropt), run.model),
        model_params_from_reference(ref_params(arch, dtype), run.model),
        dtype=dtype)
    for k, p in params.items():     # the model's dtype; a router float32
        assert p.dtype == want[k].dtype, k


def test_train_step_learns_with_compression():
    """The reference's compressed-step test: 15 steps on one batch at lr
    1e-2 overfit it (the loss falls by more than 1)."""
    _, run = runs("granite-3-2b", "bfloat16", optimizer=dict(
        lr=1e-2, warmup_steps=0, total_steps=100, compress_grads=True))
    ts = make_train_step(run, device="cpu")
    params, opt, ef = ts.init_state(torch.Generator().manual_seed(0))
    assert ef is not None
    batch = TokenPipeline(run.model, run.shape).batch(0)
    losses = []
    for _ in range(15):
        params, opt, ef, m = ts.step(params, opt, ef, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0


def test_train_step_checks_its_inputs():
    _, run = runs("granite-3-2b", "float32", microbatches=2)
    ts = make_train_step(run, device="cpu")
    params, opt, ef = ts.init_state(torch.Generator().manual_seed(0))
    assert ts.input_structs["tokens"].shape == (2, 1, 32)
    flat = TokenPipeline(run.model, run.shape).batch(0)
    with pytest.raises(ValueError, match="tokens of shape"):
        ts.step(params, opt, ef, flat)
    split = {"tokens": flat["tokens"].reshape(2, 1, 32)}
    with pytest.raises(ValueError, match="own model parameters"):
        ts.step({k: v.clone() for k, v in params.items()}, opt, ef, split)
    with pytest.raises(NotImplementedError, match="not this family's"):
        ts.step(params, opt, ef, {**split, "prefix_embeds": np.zeros(1)})
    # the gradient half writes nothing; the update half writes in place
    before = {k: v.clone() for k, v in params.items()}
    loss, grads = ts.grads(params, split)
    assert int(opt.step) == 0 and grads.keys() == params.keys()
    assert all(torch.equal(before[k], params[k]) for k in params)
    _, opt2, _, om = ts.apply(params, opt, ef, grads)
    assert int(opt2.step) == 1 and opt2.m is opt.m
    assert om.keys() == {"lr", "grad_norm"}
    assert not all(torch.equal(before[k], params[k]) for k in params)
    with pytest.raises(NotImplementedError, match="A6b"):
        RunConfig(model=run.model, shape=run.shape, mesh=run.mesh, fsdp=True)
    for unread in (dict(private_embed=True), dict(pir=PIR_CONFIGS["pir-smoke"])):
        with pytest.raises(NotImplementedError, match="private_inference"):
            RunConfig(model=run.model, shape=run.shape, mesh=run.mesh,
                      **unread)
    with pytest.raises(ValueError, match="microbatches"):
        RunConfig(model=run.model, shape=run.shape, mesh=run.mesh,
                  microbatches=3)


# -- TrainLoop --------------------------------------------------------------------

def loops(tmp_path, *, steps=6, ckpt_every=2, total_steps=None, tag="",
          arch="granite-3-2b", optimizer="adamw"):
    """A reference and a port loop over ``arch``'s SMOKE in float32 from
    the same weights, each checkpointing under its own directory."""
    ref_run, run = runs(arch, "float32", optimizer=dict(
        name=optimizer, lr=1e-3, warmup_steps=1,
        total_steps=total_steps or steps))
    quiet = lambda s: None
    ref = RefTrainLoop(ref_run, make_local_mesh(), RefLoopConfig(
        total_steps=steps, ckpt_every=ckpt_every, log_every=0,
        ckpt_dir=str(tmp_path / f"ref{tag}")), log=quiet)
    port = TrainLoop(run, TrainLoopConfig(
        total_steps=steps, ckpt_every=ckpt_every, log_every=0,
        ckpt_dir=str(tmp_path / f"port{tag}")), device="cpu", log=quiet)
    init = port.ts.init_state

    def from_reference(generator):
        load_reference_weights(port.ts.model, arch, "float32")
        return init(None)
    port.ts = port.ts._replace(init_state=from_reference)
    return ref, port


def poison(loop, bad_calls, *, port: bool):
    """Make the loss the policy sees NaN on the given step calls. The
    port's gradient half computes the gradients and returns a NaN loss. The
    reference's poisoned call returns its inputs with a NaN loss and runs
    nothing: its jitted step donates the trees, and the loop's skip keeps
    the donated ones, so a real step there makes the next use of the kept
    trees raise "Array has been deleted" on a backend that honours
    donation (the reference's fault, ROADMAP §C)."""
    if port:
        real, calls = loop.ts.grads, [0]

        def grads(params, batch):
            i = calls[0]
            calls[0] += 1
            loss, g = real(params, batch)
            return (torch.tensor(float("nan")) if i in bad_calls else loss), g
        loop.ts = loop.ts._replace(grads=grads)
        return
    real, calls = loop.ts.step, [0]

    def step(params, opt, ef, batch):
        i = calls[0]
        calls[0] += 1
        if i not in bad_calls:
            return real(params, opt, ef, batch)
        return params, opt, ef, {"loss": jnp.nan}
    loop.ts = loop.ts._replace(step=step)


def run_both(ref, port):
    with ref.mesh:
        want = ref.run_loop()
    return want, port.run_loop()


def same_result(got, want):
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert (got.skipped_steps, got.rewinds, got.final_step) == \
        (want.skipped_steps, want.rewinds, want.final_step)


def test_train_loop_with_checkpointing_matches_the_reference(tmp_path):
    ref, port = loops(tmp_path)
    want, got = run_both(ref, port)
    same_result(got, want)
    assert got.final_step == 6 and len(got.losses) == 6
    assert port.ckpt.all_steps() == ref.ckpt.all_steps() == [2, 4, 6]
    params = dict(port.ts.model.named_parameters())
    tree, meta = port.ckpt.restore({"params": params, "opt": None})
    with open(os.path.join(ref.ckpt.root, "step_00000006",
                           "manifest.json")) as f:
        ref_meta = json.load(f)
    assert meta["step"] == 6 and meta["config"] == ref_meta["config"]
    for k, p in params.items():
        assert torch.equal(tree["params"][k], p.detach())


def test_train_loop_poison_skip_and_rewind_match_the_reference(tmp_path):
    """A NaN on call 3 is skipped; NaNs on calls 5, 6, 7 rewind to the
    checkpoint at step 6; both packages then finish at step 8."""
    ref, port = loops(tmp_path, steps=8)
    poison(ref, {3, 5, 6, 7}, port=False)
    poison(port, {3, 5, 6, 7}, port=True)
    want, got = run_both(ref, port)
    same_result(got, want)
    assert (got.skipped_steps, got.rewinds, got.final_step) == (3, 1, 8)
    assert len(got.losses) == 6


def count_observations(loop):
    seen, observe = [], loop.poison.observe

    def counted(loss):
        seen.append(loss)
        return observe(loss)
    loop.poison.observe = counted
    return seen


def test_train_loop_retries_the_gradients_and_not_the_update(tmp_path):
    """A RuntimeError in the gradients of step 2 is retried and the run
    equals the reference's; the policy sees each step's loss once. A
    RuntimeError in the update, which has written in place, is not
    retried: it leaves the loop after the policy's one observation."""
    ref, port = loops(tmp_path)
    real, calls = port.ts.grads, [0]

    def grads(*a):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("CUDA out of memory (injected)")
        return real(*a)
    port.ts = port.ts._replace(grads=grads)
    seen = count_observations(port)
    want, got = run_both(ref, port)
    same_result(got, want)
    assert calls[0] == 7 and len(seen) == 6

    _, port = loops(tmp_path, tag="-update")
    applied, real_apply = [], port.ts.apply

    def apply(*a):
        applied.append(1)
        if len(applied) == 2:
            raise RuntimeError("CUDA out of memory (injected)")
        return real_apply(*a)
    port.ts = port.ts._replace(apply=apply)
    seen = count_observations(port)
    with pytest.raises(RuntimeError, match="injected"):
        port.run_loop()
    assert len(applied) == 2 and len(seen) == 2


def test_train_loop_resume(tmp_path):
    """The reference's resume case (nothing left past the last
    checkpoint), then a run stopped at step 3 and resumed to 6 equal to
    the uninterrupted run's last three steps."""
    _, port = loops(tmp_path, steps=4)
    port.run_loop()
    _, again = loops(tmp_path, steps=4)
    res = again.run_loop(resume=True)
    assert res.final_step == 4 and res.losses == []

    _, full = loops(tmp_path, steps=6, ckpt_every=3, tag="-full")
    whole = full.run_loop()
    _, first = loops(tmp_path, steps=3, ckpt_every=3, total_steps=6,
                     tag="-split")
    first.run_loop()
    _, second = loops(tmp_path, steps=6, ckpt_every=3, tag="-split")
    rest = second.run_loop(resume=True)
    assert rest.final_step == 6
    assert rest.losses == whole.losses[3:]


def test_train_loop_stops_on_sigterm(tmp_path):
    """SIGTERM during step 2: the loop finishes that step, checkpoints at
    step 3 and stops; the previous handler is back afterwards."""
    _, port = loops(tmp_path, steps=6)
    real, calls = port.ts.grads, [0]

    def grads(*a):
        calls[0] += 1
        if calls[0] == 3:
            signal.raise_signal(signal.SIGTERM)
        return real(*a)
    port.ts = port.ts._replace(grads=grads)
    before = signal.getsignal(signal.SIGTERM)
    res = port.run_loop()
    assert signal.getsignal(signal.SIGTERM) is before
    assert res.final_step == 3 and len(res.losses) == 3
    assert port.ckpt.latest_step() == 3


# -- entry points ------------------------------------------------------------------

def test_launch_train_smoke_on_the_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "4",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu", "--optimizer", "adafactor",
            "--microbatches", "2", "--compress-grads"]
    with redirect_stdout(out):
        assert launch_train.main(argv) == 0
    assert "done at step 4 on cpu" in out.getvalue()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    with redirect_stdout(out):
        assert launch_train.main(argv + ["--resume"]) == 0
    assert "no step left to run" in out.getvalue()


def test_train_lm_tiny_on_the_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        assert train_lm.main(["--tiny", "--steps", "4", "--seq", "64",
                              "--ckpt-dir", str(tmp_path),
                              "--device", "cpu"]) == 0
    text = out.getvalue()
    assert "model lm-tiny" in text and "done: step 4" in text
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003",
                                            "step_00000004"]



def test_train_lm_models_are_the_examples():
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm", ROOT / "examples" / "train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for name in ("model_100m", "model_tiny"):
        assert getattr(train_lm, name)().to_dict() == \
            getattr(example, name)().to_dict()


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, run = runs("granite-3-2b", "float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(run, TrainLoopConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "granite-3-2b", "--smoke",
                           "--steps", "1"])
