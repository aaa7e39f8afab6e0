"""Port: the SSM family's training half (xlstm-350m ``SMOKE``,
``XLSTMModel``) against the reference on the CPU — every gradient
against ``jax.grad``, ``leaf_groups`` against the reference's leaves
(its ``blocks`` is a list: nothing is stacked), the optimizer state
through ``convert.opt_state_from_reference``, three AdamW steps of
``make_train_step`` (the reference's policy for the arch,
``repro/launch/dryrun.py:51``), the reference-side fault C5 at a long
chunk, and ``launch.train``.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; the batches are the pipelines'
own (bit-equal in both packages). Tolerances, float32:
* gradients at chunk 16: each leaf within atol 1e-6 + rtol 1e-4 of the
  reference's (measured at most 1.1e-7 off, on leaves whose largest
  element is 8.7e-6 to 0.14), the loss rtol 1e-5 (measured 7.7e-8);
* the train step: ``tests/test_torch_train.py``'s (losses rtol 1e-5,
  parameters rtol 1e-4 / atol 1e-5, the optimizer state's difference
  within 1e-3 of its norm), but ``ADAMW_FLIPS`` of the elements may lie
  outside the tight tolerance (within its bound), as in
  ``test_torch_encdec_train_step.py``: an element whose gradient is at
  AdamW's eps (measured: ``blocks.1.mix.w_in[36, 252]``, a step-0
  gradient of -1.6e-8) moves by m / (sqrt(v) + eps), which turns on the
  gradient's last bits; it ended 1.34e-5 from the reference's, one
  element of 290,496;
* C5, the port's gradients at chunk 256 over 256 tokens against the
  reference's at chunk 16 (where they are finite): atol 1e-6 + rtol 1e-4
  (measured at most 1.5e-8); the loss at both chunks, in both packages,
  rtol 1e-6 (measured equal). 18 of the reference's 27 gradient leaves
  are non-finite at chunk 256.
torch is pinned to one thread, as in ``test_torch_train.py``.
"""
import functools
import io
import os
import re
from contextlib import redirect_stdout
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.config import OptimizerConfig as RefOptimizerConfig
from repro.models import build_model as ref_build
from repro.optim.optimizer import opt_init as ref_opt_init
from repro_torch.config import OptimizerConfig
from repro_torch.configs import SMOKES
from repro_torch.convert import (leaf_paths, model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim.optimizer import leaf_groups, opt_init, stack_leaf

import test_torch_train as ttrain

ARCH = "xlstm-350m"
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ADAMW_FLIPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_model(chunk=None, remat="block"):
    cfg = replace(SMOKES[ARCH], dtype="float32")
    if chunk is not None:
        cfg = replace(cfg, ssm=replace(cfg.ssm, chunk=chunk))
    model = build_model(cfg, device="cpu", remat=remat)
    model.load_state_dict(model_params_from_reference(
        ttrain.ref_params(ARCH, "float32"), cfg))
    model.requires_grad_(True)
    return model


def ref_grads(tokens, chunk=None):
    """The reference's loss and gradients (numpy, by the port's names)
    at ``chunk`` (the config's by default)."""
    cfg = replace(REF_SMOKES[ARCH], dtype="float32")
    if chunk is not None:
        cfg = replace(cfg, ssm=replace(cfg.ssm, chunk=chunk))
    ref = ref_build(cfg)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    ttrain.ref_params(ARCH, "float32"))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref.loss(p, t)[0]))(params, tokens)
    return float(loss), model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, grads), cfg)


def port_grads(model, tokens):
    loss, _ = model.loss(torch.from_numpy(tokens))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


# -- gradients ---------------------------------------------------------------------

def test_every_gradient_matches_jax_grad():
    """float32 at the config's chunk of 16 (two chunks a sequence): the
    gradient of every parameter (both block kinds, ``r_rec`` included,
    the tables, the norms) against ``jax.grad`` of the reference's loss,
    leaf by leaf."""
    b = TokenPipeline(SMOKES[ARCH], ttrain.SMOKE_TRAIN).batch(0)
    want_loss, want = ref_grads(b["tokens"])
    got_loss, got = port_grads(port_model(), b["tokens"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert np.isfinite(want[name].numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    # the table's padding rows get no gradient in either package
    assert not got["embed"][SMOKES[ARCH].vocab:].any()
    assert got["blocks.1.mix.r_rec"].dtype == torch.float32


def test_c5_gradients_at_a_long_chunk():
    """C5 (ROADMAP §C): at chunk 256 over 2 x 256 tokens the reference's
    loss is its chunk-16 loss, but some of its gradient leaves are
    non-finite (the exp of the unmasked upper decay triangle overflows and
    its gradient is 0 x inf); the port masks the exponent first, so its
    chunk-256 gradients are finite and equal the reference's chunk-16
    ones."""
    tokens = np.random.default_rng(31).integers(
        0, SMOKES[ARCH].vocab, (2, 256)).astype(np.int32)
    loss16, want = ref_grads(tokens, chunk=16)
    loss256, bad = ref_grads(tokens, chunk=256)
    np.testing.assert_allclose(loss256, loss16, rtol=1e-6)
    non_finite = sorted(k for k, g in bad.items()
                        if not np.isfinite(g.numpy()).all())
    assert "blocks.0.mix.wqkv" in non_finite and "embed" in non_finite
    assert all(np.isfinite(g.numpy()).all() for g in want.values())
    got_loss, got = port_grads(port_model(chunk=256), tokens)
    np.testing.assert_allclose(got_loss, loss16, rtol=1e-6)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


# -- the optimizer's leaves and state ------------------------------------------

def test_leaf_groups_are_the_reference_leaves():
    """The optimizer's and the compression's statistics are taken over the
    reference's leaves: each ``blocks.{i}.<path>`` its own leaf
    ``blocks/{i}/<path>`` (the reference's list is not stacked), the
    tables and the final norm theirs; each group has the reference's
    shape."""
    model = port_model()
    tensors = dict(model.named_parameters())
    groups = leaf_groups(tensors)
    ref = dict(leaf_paths(ttrain.ref_params(ARCH, "float32")))
    assert groups.keys() == ref.keys()
    assert groups["blocks/1/mix/r_rec"] == ["blocks.1.mix.r_rec"]
    assert groups["blocks/0/mix/conv_w"] == ["blocks.0.mix.conv_w"]
    assert groups["embed"] == ["embed"]
    assert all(len(names) == 1 for names in groups.values())
    for key, names in groups.items():
        assert tuple(stack_leaf(tensors, key, names).shape) == \
            ref[key].shape, key


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_from_reference(name):
    """The reference's fresh optimizer state over the list of blocks,
    converted: AdamW's ``m`` / ``v`` / ``master`` keyed by the port's
    parameter names with the same bits (``master`` float32, ``r_rec``'s
    included), Adafactor's keyed by the reference's leaf paths, each the
    shape and dtype of the port's own ``opt_init``."""
    params = ttrain.ref_params(ARCH, "float32")
    rstate = jax.tree_util.tree_map(np.asarray, ref_opt_init(
        RefOptimizerConfig(name=name),
        jax.tree_util.tree_map(jnp.asarray, params)))
    got = opt_state_from_reference(rstate, SMOKES[ARCH])
    mine = opt_init(OptimizerConfig(name=name),
                    dict(port_model().named_parameters()))
    assert int(got.step) == 0
    for field in got._fields[1:]:
        g, m = getattr(got, field), getattr(mine, field)
        assert g.keys() == m.keys(), field
        for k in g:
            assert (g[k] is None) == (m[k] is None), (field, k)
            if g[k] is not None:
                assert g[k].shape == m[k].shape, (field, k)
                assert g[k].dtype == m[k].dtype, (field, k)
                assert torch.equal(g[k], m[k]), (field, k)
    if name == "adamw":
        assert got.master["blocks.1.mix.r_rec"].dtype == torch.float32
        assert "blocks.3.mix.w_in" in got.m
    else:
        assert "blocks/3/mix/w_in" in got.vr


# -- make_train_step ------------------------------------------------------------------

def test_train_step_matches_the_reference():
    """Three AdamW steps in one microbatch from the reference's weights,
    against the reference's ``make_train_step``: losses, the schedule,
    parameters and the optimizer state."""
    ttrain.check_train_step(
        (ARCH, "adamw", 1, False, "float32"),
        check_params=functools.partial(ttrain.param_check,
                                       flips=ADAMW_FLIPS))


def test_train_step_takes_tokens_only():
    """The step's inputs are ``tokens`` alone; a side input is another
    family's and is refused before anything is written."""
    _, run = ttrain.runs(ARCH, "float32")
    from repro_torch.runtime.steps import make_train_step
    ts = make_train_step(run, device="cpu")
    assert set(ts.input_structs) == {"tokens"}
    params, opt, ef = ts.init_state(torch.Generator().manual_seed(0))
    b = TokenPipeline(run.model, run.shape).batch(0)
    assert set(b) == {"tokens"}
    with pytest.raises(NotImplementedError, match="frame_embeds"):
        ts.step(params, opt, ef, dict(b, frame_embeds=np.zeros(1)))
    assert int(opt.step) == 0
    params, opt, ef, m = ts.step(params, opt, ef, b)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))


# -- the launcher ---------------------------------------------------------------------

def test_launch_train_xlstm_smoke_runs_20_steps_on_the_cpu(tmp_path):
    """``--arch xlstm-350m --smoke`` through TrainLoop: 20 AdamW steps,
    the loss falling; checkpoints, and a resume with nothing left."""
    out = io.StringIO()
    argv = ["--arch", ARCH, "--smoke", "--steps", "20", "--lr", "1e-2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
            "--device", "cpu"]
    with redirect_stdout(out):
        assert launch_train.main(argv) == 0
    text = out.getvalue()
    done = re.search(r"done at step 20 on cpu; loss (\S+) -> (\S+);", text)
    assert done and float(done.group(2)) < float(done.group(1))
    assert sorted(os.listdir(tmp_path)) == ["step_00000010",
                                            "step_00000020"]
    with redirect_stdout(out):
        assert launch_train.main(argv + ["--resume"]) == 0
    assert "no step left to run" in out.getvalue()
