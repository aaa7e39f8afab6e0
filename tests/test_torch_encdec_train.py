"""Port: the audio family's training half (whisper-small ``SMOKE``,
``EncDecLM``) against the reference on the CPU — ``loss`` with the
pipeline's ``frame_embeds``, every gradient against ``jax.grad``,
``leaf_groups`` against the reference's leaves, ``make_train_step`` with
the frames split into microbatches, and ``launch.train``. The train step
against the reference's over three steps is
``test_torch_encdec_train_step.py``'s.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; the batches are the pipelines'
own (bit-equal in both packages, the frame stub included), the frames
handed to both packages in the config's dtype. Tolerances:
* ``loss``: ``tests/test_torch_train.py``'s, float32 rtol 1e-5, bfloat16
  atol 2e-2;
* gradients, float32: each leaf within atol 1e-6 + rtol 1e-4 of the
  reference's (measured: at most 5.2e-8 off, on leaves whose largest
  element is 2.8e-4 to 0.25);
* the step's loss over two microbatches: the mean of each sequence's
  loss rtol 1e-6, its gradients the mean of theirs rtol 1e-5 / atol 1e-7
  (float32, the same sums in another order).
torch is pinned to one thread, as in ``test_torch_train.py``.
"""
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
from repro.models import build_model as ref_build
from repro_torch.configs import SMOKES
from repro_torch.convert import leaf_paths, model_params_from_reference
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.transformer import _xent
from repro_torch.optim.optimizer import leaf_groups, stack_leaf
from repro_torch.runtime.steps import make_train_step

import test_torch_train as ttrain

ARCH = "whisper-small"
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at smoke shapes torch's threads buy nothing,
    and under the suite's parallel workers they contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch0(cfg, batch=2):
    """The pipeline's batch 0 at SMOKE_TRAIN (32 tokens and 30 frames a
    sequence), as numpy."""
    shape = replace(ttrain.SMOKE_TRAIN, global_batch=batch)
    return TokenPipeline(cfg, shape).batch(0)


def port_model(dtype, remat="block"):
    model = build_model(replace(SMOKES[ARCH], dtype=dtype), device="cpu",
                        remat=remat)
    ttrain.load_reference_weights(model, ARCH, dtype)
    return model


def ref_loss_fn(dtype):
    ref = ref_build(replace(REF_SMOKES[ARCH], dtype=dtype))
    return lambda p, t, f: ref.loss(p, t, frame_embeds=f)[0]


# -- the loss and its gradients ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_the_reference(dtype):
    """The loss (empty metrics, no aux term) with the pipeline's frames
    against the reference's; it is the cross-entropy of the forward's
    logits[:, :-1] against tokens[:, 1:]; other frames change it."""
    ref = ref_build(replace(REF_SMOKES[ARCH], dtype=dtype))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    ttrain.ref_params(ARCH, dtype))
    b = batch0(SMOKES[ARCH])
    want, wm = jax.jit(lambda p, t, f: ref.loss(p, t, frame_embeds=f))(
        params, b["tokens"], jnp.asarray(b["frame_embeds"], JNP_DT[dtype]))
    assert wm == {}
    port = port_model(dtype)
    tok = torch.from_numpy(b["tokens"])
    fr = torch.from_numpy(b["frame_embeds"]).to(TORCH_DT[dtype])
    got, gm = port.loss(tok, frame_embeds=fr)
    assert gm == {}
    tol = dict(rtol=1e-5, atol=0) if dtype == "float32" else \
        dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(float(got), float(want), **tol)
    logits, _ = port.forward(tok, frame_embeds=fr)
    assert torch.equal(got.detach(), _xent(logits[:, :-1],
                                           tok[:, 1:].long()))
    other, _ = port.loss(tok, frame_embeds=fr * 50)
    assert float(other) != float(got)


def test_every_gradient_matches_jax_grad():
    """float32: the gradient of every parameter (both stacks' layers, the
    tied table, pos_dec, both norms) against ``jax.grad`` of the
    reference's loss, leaf by leaf, unstacked."""
    params = jax.tree_util.tree_map(jnp.asarray,
                                    ttrain.ref_params(ARCH, "float32"))
    b = batch0(SMOKES[ARCH])
    rgrads = jax.jit(jax.grad(ref_loss_fn("float32")))(
        params, b["tokens"], b["frame_embeds"])
    want = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, rgrads), SMOKES[ARCH])
    port = port_model("float32")
    port.requires_grad_(True)
    loss, _ = port.loss(torch.from_numpy(b["tokens"]),
                        frame_embeds=torch.from_numpy(b["frame_embeds"]))
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        port.parameters()))))
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    # rows of pos_dec past the sequence and the table's padding rows get
    # no gradient in either package
    assert not grads["pos_dec"][32:].any()
    assert not grads["embed"][SMOKES[ARCH].vocab:].any()


def test_leaf_groups_are_the_reference_leaves():
    """The optimizer's and the compression's statistics are taken over the
    reference's leaves: ``enc_layers/<path>`` and ``dec_layers/<path>``
    stack their layers in order, every other parameter is its own leaf;
    each stacked group has the reference's shape."""
    model = port_model("float32")
    tensors = dict(model.named_parameters())
    groups = leaf_groups(tensors)
    ref = dict(leaf_paths(ttrain.ref_params(ARCH, "float32")))
    assert groups.keys() == ref.keys()
    assert groups["enc_layers/attn/wq"] == [
        f"enc_layers.{i}.attn.wq" for i in range(2)]
    assert groups["dec_layers/cross_attn/wk"] == [
        f"dec_layers.{i}.cross_attn.wk" for i in range(2)]
    assert groups["pos_dec"] == ["pos_dec"]
    assert groups["enc_norm/scale"] == ["enc_norm.scale"]
    for key, names in groups.items():
        assert tuple(stack_leaf(tensors, key, names).shape) == \
            ref[key].shape, key


# -- make_train_step ----------------------------------------------------------------

def test_microbatches_take_their_own_frames():
    """Two microbatches of one sequence: the step's loss is the mean of
    each sequence's loss with its own frames, its gradients the mean of
    theirs; swapping the two sequences' frames changes the loss."""
    _, run = ttrain.runs(ARCH, "float32", microbatches=2)
    ts = make_train_step(run, device="cpu")
    ttrain.load_reference_weights(ts.model, ARCH, "float32")
    params, _, _ = ts.init_state(None)
    assert ts.input_structs["tokens"].shape == (2, 1, 32)
    assert ts.input_structs["frame_embeds"].shape == (2, 1, 30, 64)
    b = TokenPipeline(run.model, run.shape).batch(0)
    split = {k: v.reshape(ts.input_structs[k].shape) for k, v in b.items()}
    loss, grads = ts.grads(params, split)
    losses, each = [], []
    for i in range(2):
        li, _ = ts.model.loss(torch.from_numpy(b["tokens"][i:i + 1]),
                              frame_embeds=torch.from_numpy(
                                  b["frame_embeds"][i:i + 1]))
        losses.append(li.detach())
        each.append(torch.autograd.grad(li, list(params.values())))
    torch.testing.assert_close(loss, sum(losses) / 2, rtol=1e-6, atol=0)
    for (name, g), g0, g1 in zip(grads.items(), *each):
        torch.testing.assert_close(g, (g0 + g1) / 2, rtol=1e-5, atol=1e-7,
                                   msg=name)
    swapped = dict(split, frame_embeds=split["frame_embeds"][::-1].copy()
                   * 50)
    assert float(ts.grads(params, swapped)[0]) != float(loss)


def test_train_step_checks_the_frames():
    """The step refuses a batch without the frames, with frames of another
    row count, or with another family's input, and updates nothing."""
    _, run = ttrain.runs(ARCH, "float32")
    ts = make_train_step(run, device="cpu")
    params, opt, ef = ts.init_state(torch.Generator().manual_seed(0))
    b = TokenPipeline(run.model, run.shape).batch(0)
    with pytest.raises(ValueError, match="lacks 'frame_embeds'"):
        ts.step(params, opt, ef, {"tokens": b["tokens"]})
    with pytest.raises(ValueError, match="frame_embeds of shape"):
        ts.step(params, opt, ef, dict(b, frame_embeds=b["frame_embeds"][
            :, :10]))
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        ts.step(params, opt, ef, dict(b, prefix_embeds=np.zeros(1)))
    assert int(opt.step) == 0
    params, opt, ef, m = ts.step(params, opt, ef, b)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))


# -- the launcher -----------------------------------------------------------------

def test_launch_train_whisper_smoke_runs_20_steps_on_the_cpu(tmp_path):
    """``--arch whisper-small --smoke`` through TrainLoop: 20 AdamW steps
    in two microbatches (the reference's policy for the arch), the loss
    falling; checkpoints, and a resume with nothing left to run."""
    out = io.StringIO()
    argv = ["--arch", ARCH, "--smoke", "--steps", "20", "--lr", "1e-2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
            "--device", "cpu", "--microbatches", "2"]
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
