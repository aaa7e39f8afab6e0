"""Port: the hybrid family's training half (zamba2-7b ``SMOKE``,
``Zamba2Model``) against the reference on the CPU — every gradient
against ``jax.grad`` (the shared block's the sum over its invocations),
the reference-side fault C5 at the published chunk of 256,
``leaf_groups`` against the reference's stacked ``mamba_layers`` leaves
and its ``shared`` subtree, and the optimizer state through
``convert.opt_state_from_reference`` (the train steps and
``launch.train``: ``test_torch_zamba2_train_step.py``).

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; the batches are the pipelines'
own (bit-equal in both packages). Tolerances, float32:
* gradients at chunk 16: each leaf within atol 1e-6 + rtol 1e-4 of the
  reference's (measured at most 3.3e-7 off, on leaves whose largest
  element is 3.9e-5 to 0.26), the loss rtol 1e-5 (measured 1.5e-7);
* the shared block's gradient against the sum of the gradients of one
  copy of its weights per invocation: atol 1e-7 (measured 0);
* C5, the port's gradients at chunk 256 over 2 x 256 tokens against the
  reference's at chunk 16 (where they are finite): atol 1e-6 + rtol 1e-4
  (measured at most 6.5e-8); the losses at both chunks rtol 1e-6
  (measured 7.6e-8). 47 of the port's 52 gradient tensors are
  non-finite in the reference at chunk 256: every Mamba layer's but the
  last one's ``d_skip``, ``mix.norm`` and ``out_proj``, the shared
  block's and the embedding's.
torch is pinned to one thread, as in ``test_torch_train.py``.
"""
import copy
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
from repro_torch.models import build_model
from repro_torch.optim.optimizer import leaf_groups, opt_init, stack_leaf

import test_torch_train as ttrain

ARCH = "zamba2-7b"
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_chunk(cfg, chunk):
    return cfg if chunk is None else replace(
        cfg, ssm=replace(cfg.ssm, chunk=chunk))


def port_model(chunk=None, remat="block"):
    cfg = with_chunk(replace(SMOKES[ARCH], dtype="float32"), chunk)
    model = build_model(cfg, device="cpu", remat=remat)
    model.load_state_dict(model_params_from_reference(
        ttrain.ref_params(ARCH, "float32"), cfg))
    model.requires_grad_(True)
    return model


def ref_grads(tokens, chunk=None):
    """The reference's loss and gradients (numpy, by the port's names)
    at ``chunk`` (the config's by default)."""
    cfg = with_chunk(replace(REF_SMOKES[ARCH], dtype="float32"), chunk)
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
    gradient of every parameter (every Mamba layer's, the float32
    ``a_log`` / ``dt_bias`` / ``d_skip`` included, the shared block's,
    the tables, the norms) against ``jax.grad`` of the reference's loss,
    leaf by leaf."""
    b = TokenPipeline(SMOKES[ARCH], ttrain.SMOKE_TRAIN).batch(0)
    want_loss, want = ref_grads(b["tokens"])
    got_loss, got = port_grads(port_model(), b["tokens"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert got.keys() == want.keys() and len(got) == 52
    for name, g in got.items():
        assert np.isfinite(want[name].numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    assert not got["embed"][SMOKES[ARCH].vocab:].any()
    assert got["mamba_layers.2.mix.a_log"].dtype == torch.float32


def test_shared_gradient_is_the_sum_over_invocations():
    """With one copy of the shared block's weights per invocation, the
    loss is the same, and the shared block's gradient in the model is the
    sum of the copies' gradients (autograd sums over the invocations, as
    ``jax.grad`` over the reference's reuse)."""
    model = port_model(remat="none")
    tokens = TokenPipeline(SMOKES[ARCH], ttrain.SMOKE_TRAIN).batch(1)[
        "tokens"]
    loss, grads = port_grads(model, tokens)
    copies = [copy.deepcopy(model.shared) for _ in range(model.n_groups)]
    calls = iter(copies)
    shared_block = model._shared_block

    def per_invocation(*args, **kw):
        model._modules["shared"] = next(calls)
        return shared_block(*args, **kw)

    original = model.shared
    model._shared_block = per_invocation
    try:
        loss2, _ = model.loss(torch.from_numpy(tokens))
    finally:
        del model._shared_block
        model._modules["shared"] = original
    assert next(calls, None) is None
    assert float(loss2.detach()) == loss
    names = [n for n, _ in copies[0].named_parameters()]
    per_copy = [torch.autograd.grad(loss2, list(c.parameters()),
                                    retain_graph=True) for c in copies]
    for i, name in enumerate(names):
        total = sum(g[i] for g in per_copy)
        torch.testing.assert_close(grads[f"shared.{name}"], total, rtol=0,
                                   atol=1e-7)
        assert not torch.equal(per_copy[0][i], per_copy[1][i]), name


def test_c5_gradients_at_the_published_chunk():
    """C5 (ROADMAP §C) for the hybrid: at chunk 256 over 2 x 256 tokens
    the reference's loss is its chunk-16 loss, but most of its gradient
    leaves are non-finite (Mamba2's decay is about -1 a step at the
    reference's initial a_log and dt_bias, so the unmasked upper triangle
    of a 256-step decay block reaches about 255 and its exp overflows);
    the port masks the exponent first, so its chunk-256 gradients are
    finite and equal the reference's chunk-16 ones."""
    tokens = np.random.default_rng(31).integers(
        0, SMOKES[ARCH].vocab, (2, 256)).astype(np.int32)
    loss16, want = ref_grads(tokens, chunk=16)
    loss256, bad = ref_grads(tokens, chunk=256)
    np.testing.assert_allclose(loss256, loss16, rtol=1e-6)
    finite = sorted(k for k, g in bad.items() if np.isfinite(g.numpy()).all())
    assert finite == ["final_norm", "mamba_layers.4.mix.d_skip",
                      "mamba_layers.4.mix.norm", "mamba_layers.4.mix.out_proj",
                      "unembed"]
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
    reference's leaves: ``mamba_layers.{i}.<path>`` stacked into
    ``mamba_layers/<path>`` (the float32 ``a_log`` of 5 layers one [5, 8]
    leaf, which Adafactor factors over the layer axis, as the reference
    does), the shared block's ``shared/<path>`` unstacked, the tables and
    the final norm theirs; each group has the reference's shape."""
    tensors = dict(port_model().named_parameters())
    groups = leaf_groups(tensors)
    ref = dict(leaf_paths(ttrain.ref_params(ARCH, "float32")))
    assert groups.keys() == ref.keys()
    assert groups["mamba_layers/mix/a_log"] == [
        f"mamba_layers.{i}.mix.a_log" for i in range(5)]
    assert groups["shared/attn/wq"] == ["shared.attn.wq"]
    assert groups["embed"] == ["embed"]
    for key, names in groups.items():
        assert tuple(stack_leaf(tensors, key, names).shape) == \
            ref[key].shape, key
    assert ref["mamba_layers/mix/a_log"].shape == (5, 8)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_from_reference(name):
    """The reference's fresh optimizer state, converted: AdamW's ``m`` /
    ``v`` / ``master`` keyed by the port's parameter names with the same
    bits, Adafactor's keyed by the reference's leaf paths (the stacked
    rank-2 ``a_log`` factored into ``vr`` [5] and ``vc`` [8]), each the
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
        assert got.master["mamba_layers.3.mix.dt_bias"].dtype == \
            torch.float32
        assert "shared.mlp.down" in got.m
    else:
        assert got.vr["mamba_layers/mix/a_log"].shape == (5,)
        assert got.vc["mamba_layers/mix/a_log"].shape == (8,)
        assert got.v["mamba_layers/norm"] is None
