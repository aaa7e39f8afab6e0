"""Port: the VLM family's training half (llava-next-34b ``SMOKE``) against
the reference on the CPU — ``loss`` with ``prefix_embeds``,
``make_train_step`` with the prefix split into microbatches, ``TrainLoop``
with checkpoints and resume, and ``launch.train``. The train step against
the reference's over three steps is ``test_torch_vlm_train_step.py``'s.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; the batches are the pipelines'
own (bit-equal in both packages, the prefix stub included). Tolerances are
``tests/test_torch_train.py``'s:
* ``loss``: float32 rtol 1e-5, bfloat16 atol 2e-2;
* the step's loss over two microbatches: the mean of each sequence's
  loss rtol 1e-6, its gradients the mean of theirs rtol 1e-5 / atol 1e-7
  (float32, the same sums in another order);
* ``TrainLoop``: losses rtol 1e-5, the same skips, final step and
  checkpoints; the port resumed from its own checkpoint equals its
  uninterrupted run exactly (the CPU is deterministic).
torch is pinned to one thread, as in ``test_torch_train.py``.
"""
import io
import os
from contextlib import redirect_stdout
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import build_model as ref_build
from repro_torch.configs import SMOKES
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.transformer import _xent
from repro_torch.runtime.steps import make_train_step

import test_torch_train as ttrain

ARCH = "llava-next-34b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at smoke shapes torch's threads buy nothing,
    and under the suite's parallel workers they contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch0(cfg, batch=2):
    """The pipeline's batch 0 at SMOKE_TRAIN (24 text tokens behind 8
    prefix rows a sequence), as numpy."""
    shape = replace(ttrain.SMOKE_TRAIN, global_batch=batch)
    return TokenPipeline(cfg, shape).batch(0)


def port_model(dtype, remat="block"):
    model = build_model(replace(SMOKES[ARCH], dtype=dtype), device="cpu",
                        remat=remat)
    ttrain.load_reference_weights(model, ARCH, dtype)
    return model


# -- the loss ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_the_reference(dtype):
    """The loss and its metrics with the pipeline's prefix against the
    reference's; the cross-entropy is the mean over the S - 1 predictions
    from the token positions of each sequence (none at a prefix
    position); another prefix changes it."""
    ref = ref_build(replace(REF_SMOKES[ARCH], dtype=dtype))
    params = jax.tree_util.tree_map(jax.numpy.asarray,
                                    ttrain.ref_params(ARCH, dtype))
    b = batch0(SMOKES[ARCH])
    want, wm = jax.jit(lambda p, t, pe: ref.loss(p, t, prefix_embeds=pe))(
        params, b["tokens"], b["prefix_embeds"])
    port = port_model(dtype)
    tok, pre = (torch.from_numpy(b["tokens"]),
                torch.from_numpy(b["prefix_embeds"]))
    got, gm = port.loss(tok, prefix_embeds=pre)
    tol = dict(rtol=1e-5, atol=0) if dtype == "float32" else \
        dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(float(got), float(want), **tol)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **tol)
    assert float(gm["aux"]) == 0.0 == float(wm["aux"])
    n = SMOKES[ARCH].n_frontend_tokens
    logits, _ = port.forward(tok, prefix_embeds=pre)
    per = (torch.logsumexp(logits[:, n:-1], -1) - torch.gather(
        logits[:, n:-1], -1, tok[:, 1:, None].long())[..., 0])
    assert per.shape == (2, tok.shape[1] - 1)
    assert torch.equal(gm["ce"].detach(), _xent(logits[:, n:-1],
                                                tok[:, 1:].long()))
    torch.testing.assert_close(gm["ce"].detach(), per.mean(),
                               rtol=1e-6, atol=0)
    other, _ = port.loss(tok, prefix_embeds=pre * 50)
    assert float(other) != float(got)


def test_remat_keeps_the_loss_and_gradients_with_a_prefix():
    """remat="block" recomputes each block from its input, the prefix rows
    included: the same loss and gradients as remat="none", bit for bit on
    the CPU."""
    b = batch0(SMOKES[ARCH])
    out = {}
    for remat in ("none", "block"):
        model = port_model("float32", remat)
        model.requires_grad_(True)
        loss, _ = model.loss(torch.from_numpy(b["tokens"]),
                             prefix_embeds=torch.from_numpy(
                                 b["prefix_embeds"]))
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    assert torch.equal(out["none"][0], out["block"][0])
    for a, g in zip(out["none"][1], out["block"][1]):
        assert torch.equal(a, g)


# -- make_train_step ----------------------------------------------------------------

def test_microbatches_take_their_own_prefix():
    """Two microbatches of one sequence: the step's loss is the mean of
    each sequence's loss with its own prefix, its gradients the mean of
    theirs; swapping the two prefixes changes the loss."""
    _, run = ttrain.runs(ARCH, "float32", microbatches=2)
    ts = make_train_step(run, device="cpu")
    ttrain.load_reference_weights(ts.model, ARCH, "float32")
    params, _, _ = ts.init_state(None)
    assert ts.input_structs["tokens"].shape == (2, 1, 24)
    assert ts.input_structs["prefix_embeds"].shape == (2, 1, 8, 64)
    b = TokenPipeline(run.model, run.shape).batch(0)
    split = {k: v.reshape(ts.input_structs[k].shape) for k, v in b.items()}
    loss, grads = ts.grads(params, split)
    losses, each = [], []
    for i in range(2):
        li, _ = ts.model.loss(torch.from_numpy(b["tokens"][i:i + 1]),
                              prefix_embeds=torch.from_numpy(
                                  b["prefix_embeds"][i:i + 1]))
        losses.append(li.detach())
        each.append(torch.autograd.grad(li, list(params.values())))
    torch.testing.assert_close(loss, sum(losses) / 2, rtol=1e-6, atol=0)
    for (name, g), g0, g1 in zip(grads.items(), *each):
        torch.testing.assert_close(g, (g0 + g1) / 2, rtol=1e-5, atol=1e-7,
                                   msg=name)
    swapped = dict(split, prefix_embeds=split["prefix_embeds"][::-1].copy())
    assert float(ts.grads(params, swapped)[0]) != float(loss)


def test_train_step_checks_the_prefix():
    _, run = ttrain.runs(ARCH, "float32")
    ts = make_train_step(run, device="cpu")
    params, opt, ef = ts.init_state(torch.Generator().manual_seed(0))
    b = TokenPipeline(run.model, run.shape).batch(0)
    with pytest.raises(ValueError, match="lacks 'prefix_embeds'"):
        ts.step(params, opt, ef, {"tokens": b["tokens"]})
    with pytest.raises(ValueError, match="prefix_embeds of shape"):
        ts.step(params, opt, ef, dict(b, prefix_embeds=b["prefix_embeds"][
            :, :4]))
    with pytest.raises(NotImplementedError, match="frame_embeds"):
        ts.step(params, opt, ef, dict(b, frame_embeds=np.zeros(1)))
    assert int(opt.step) == 0


# -- TrainLoop and the launcher ------------------------------------------------------

def test_train_loop_with_checkpointing_matches_the_reference(tmp_path):
    """llava SMOKE with Adafactor: every batch's prefix reaches the step;
    a NaN on call 1 is skipped in both packages; the losses, skips, final
    step and checkpoints are the reference's."""
    ref, port = ttrain.loops(tmp_path, arch=ARCH, optimizer="adafactor")
    seen, grads = [], port.ts.grads

    def spy(params, batch):
        seen.append(tuple(sorted(batch)))
        return grads(params, batch)
    port.ts = port.ts._replace(grads=spy)
    ttrain.poison(ref, {1}, port=False)
    ttrain.poison(port, {1}, port=True)
    want, got = ttrain.run_both(ref, port)
    ttrain.same_result(got, want)
    assert (got.skipped_steps, got.final_step, len(got.losses)) == (1, 6, 5)
    assert port.ckpt.all_steps() == ref.ckpt.all_steps() == [2, 4, 6]
    assert seen == [("prefix_embeds", "tokens")] * 6


def test_train_loop_resume(tmp_path):
    """A run stopped at step 3 and resumed to 6 equals the uninterrupted
    run's last three steps, each batch with its prefix."""
    kw = dict(arch=ARCH, optimizer="adafactor", ckpt_every=3)
    _, full = ttrain.loops(tmp_path, steps=6, tag="-full", **kw)
    whole = full.run_loop()
    _, first = ttrain.loops(tmp_path, steps=3, total_steps=6, tag="-split",
                            **kw)
    first.run_loop()
    _, second = ttrain.loops(tmp_path, steps=6, tag="-split", **kw)
    rest = second.run_loop(resume=True)
    assert rest.final_step == 6
    assert rest.losses == whole.losses[3:]


def test_launch_train_llava_smoke_on_the_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--arch", ARCH, "--smoke", "--steps", "4",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu", "--optimizer", "adafactor",
            "--microbatches", "2"]
    with redirect_stdout(out):
        assert launch_train.main(argv) == 0
    assert "done at step 4 on cpu" in out.getvalue()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    with redirect_stdout(out):
        assert launch_train.main(argv + ["--resume"]) == 0
    assert "no step left to run" in out.getvalue()
