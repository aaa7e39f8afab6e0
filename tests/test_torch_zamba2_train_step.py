"""Port: the hybrid family's train step (zamba2-7b ``SMOKE``) against
the reference on the CPU — AdamW (the reference's policy for the arch,
``repro/launch/dryrun.py:55``) and Adafactor steps of ``make_train_step``
from the reference's weights, the step's inputs, and ``launch.train``.

Tolerances are ``tests/test_torch_train.py``'s (losses rtol 1e-5,
parameters rtol 1e-4 / atol 1e-5, the optimizer state's difference within
1e-3 of its norm), but ``ADAMW_FLIPS`` of the elements may lie outside
the tight tolerance (within its bound), as in
``test_torch_xlstm_train.py``: an element whose step-0 gradient is near
AdamW's eps moves by m / (sqrt(v) + eps), which turns on the gradient's
last bits. Measured: 4 elements of 246,648 (``mamba_layers.0.mix.
in_proj[32, 80]``, ``mamba_layers.4.mix.in_proj[26, 209]`` and two of
``mamba_layers.0.mix.out_proj``, step-0 gradients of 1.4e-9 to 1.5e-7,
e.g. 2.4e-8 in the reference and 3.3e-8 in the port), at most 7.9e-5 off.
Adafactor in two microbatches: every element within (measured).
torch is pinned to one thread.
"""
import functools
import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.runtime.steps import make_train_step

import test_torch_train as ttrain

ARCH = "zamba2-7b"
ADAMW_FLIPS = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- make_train_step ------------------------------------------------------------------

@pytest.mark.parametrize("case", [("adamw", 1), ("adafactor", 2)],
                         ids=["adamw", "adafactor-2-micro"])
def test_train_step_matches_the_reference(case):
    """Three steps from the reference's weights against the reference's
    ``make_train_step``: AdamW in one microbatch, Adafactor in two;
    losses, the schedule, parameters and the optimizer state."""
    name, micro = case
    ttrain.check_train_step(
        (ARCH, name, micro, False, "float32"),
        check_params=functools.partial(
            ttrain.param_check,
            flips=ADAMW_FLIPS if name == "adamw" else None))


def test_train_step_takes_tokens_only():
    """The step's inputs are ``tokens`` alone; a side input is another
    family's and is refused before anything is written."""
    _, run = ttrain.runs(ARCH, "float32")
    ts = make_train_step(run, device="cpu")
    assert set(ts.input_structs) == {"tokens"}
    params, opt, ef = ts.init_state(torch.Generator().manual_seed(0))
    b = TokenPipeline(run.model, run.shape).batch(0)
    assert set(b) == {"tokens"}
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        ts.step(params, opt, ef, dict(b, prefix_embeds=np.zeros(1)))
    assert int(opt.step) == 0
    params, opt, ef, m = ts.step(params, opt, ef, b)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))


# -- the launcher ---------------------------------------------------------------------

def test_launch_train_zamba2_smoke_runs_20_steps_on_the_cpu(tmp_path):
    """``--arch zamba2-7b --smoke`` through TrainLoop: 20 AdamW steps,
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
