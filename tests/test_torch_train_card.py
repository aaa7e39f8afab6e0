"""Port: the training half on the card.

Marked ``cuda``: they skip without a card (``pytest -m cuda
tests/test_torch_train_card.py`` on the card). The CPU's plain step is the
reference here: the JAX package is compared in the CPU tests
(``test_torch_train.py``, ``test_torch_optim.py``,
``test_torch_checkpoint.py``, ``test_torch_moe_train.py``).
``chip_smoke.py train_step``, ``moe_train`` and ``vlm_train`` drive the
same path at granite-3-2b's, grok-1-314b's and llava-next-34b's full
widths.
"""
from dataclasses import replace

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MeshConfig, OptimizerConfig, RunConfig
from repro_torch.configs import SMOKES
from repro_torch.configs.shapes import SMOKE_TRAIN
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.runtime.steps import make_train_step

#: card against CPU, float32: losses and parameters (cuBLAS and the CPU's
#: GEMMs sum in other orders, and AdamW's g / (|g| + eps) magnifies the
#: difference on elements with tiny gradients)
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card; "
                    "chip_smoke.py's train_parity holds the same path)")
    return torch.device("cuda")


def _run(name="adamw", arch="granite-3-2b", **kw):
    return RunConfig(model=replace(SMOKES[arch], dtype="float32"),
                     shape=SMOKE_TRAIN,
                     mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
                     optimizer=OptimizerConfig(name=name, lr=1e-3,
                                               warmup_steps=1,
                                               total_steps=10), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("adamw", {}),
                                     ("adafactor", dict(microbatches=2))])
def test_train_step_on_the_card_matches_the_cpu(card, name, kw):
    """granite SMOKE in float32: weights drawn on the CPU and copied over;
    two steps on the card equal the CPU's within LOSS_TOL / PARAM_TOL."""
    two_steps_against_the_cpu(card, _run(name, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "grok-1-314b"])
def test_moe_train_step_on_the_card_matches_the_cpu(card, arch):
    """The MoE family's SMOKE models in float32 with Adafactor over its
    ``moe_layers`` leaves and two microbatches: two steps on the card equal
    the CPU's within LOSS_TOL / PARAM_TOL (``chip_smoke.py train_parity``
    reports how many top-k routes the two sides part on)."""
    two_steps_against_the_cpu(card, _run("adafactor", arch,
                                         microbatches=2))


@pytest.mark.cuda
def test_vlm_train_step_on_the_card_matches_the_cpu(card):
    """llava SMOKE in float32 with the pipeline's prefix_embeds, Adafactor
    and two microbatches (each its slice of the prefix): two steps on the
    card equal the CPU's within LOSS_TOL / PARAM_TOL."""
    two_steps_against_the_cpu(card, _run("adafactor", "llava-next-34b",
                                         microbatches=2))


def two_steps_against_the_cpu(card, run):
    """Weights drawn on the CPU and copied to the card; two steps on each
    side: every loss within LOSS_TOL, every parameter within PARAM_TOL."""
    cpu = make_train_step(run, device="cpu")
    dev = make_train_step(run, device=card)
    cpu.model.init_params(torch.Generator().manual_seed(0))
    dev.model.load_state_dict(cpu.model.state_dict())
    states = {"cpu": cpu.init_state(None), "dev": dev.init_state(None)}
    pipe = TokenPipeline(run.model, run.shape)
    for step in range(2):
        batch = {k: v.reshape(cpu.input_structs[k].shape)
                 for k, v in pipe.batch(step).items()}
        outs = {}
        for side, ts in (("cpu", cpu), ("dev", dev)):
            p, o, e, m = ts.step(*states[side], batch)
            states[side] = (p, o, e)
            outs[side] = m
        torch.testing.assert_close(outs["dev"]["loss"].cpu(),
                                   outs["cpu"]["loss"], **LOSS_TOL)
    for k, p in states["cpu"][0].items():
        got = states["dev"][0][k]
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), p, **PARAM_TOL)


@pytest.mark.cuda
def test_checkpoint_saved_on_the_card_restores_on_the_cpu(card, tmp_path):
    run = _run()
    ts = make_train_step(run, device=card)
    params, opt, _ = ts.init_state(torch.Generator(card).manual_seed(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": params, "opt": opt})
    mgr.wait()
    tree, meta = mgr.restore({"params": params, "opt": opt}, device="cpu")
    assert meta["step"] == 3
    for k, p in params.items():
        assert tree["params"][k].device.type == "cpu"
        assert torch.equal(tree["params"][k], p.detach().cpu())
    assert torch.equal(tree["opt"].master["embed"], opt.master["embed"].cpu())
    back, _ = mgr.restore({"params": params, "opt": opt})
    assert back["params"]["embed"].device == params["embed"].device
