"""Port: the audio family's train step (whisper-small ``SMOKE``, the
pipeline's ``frame_embeds`` beside its tokens) against the reference's
``make_train_step`` on the CPU: AdamW in one microbatch and Adafactor with
``compress_grads`` in two (each microbatch its own slice of the frames),
in float32, three steps each from the reference's weights
(``test_torch_train.check_train_step``: the optimizer state carried over
through ``convert.opt_state_from_reference``, Adafactor's keyed by the
``enc_layers/...`` and ``dec_layers/...`` leaves). Tolerances are
``tests/test_torch_train.py``'s: losses rtol 1e-5, parameters rtol 1e-4 /
atol 1e-5 (with compression at most 2e-3 of the elements outside, none by
more than 2^-8 of the leaf's largest magnitude plus 2 x lr per step);
optimizer state within 1e-3 of the reference's by the norm of the
difference. One case differs: AdamW may have ``ADAMW_FLIPS`` of its
elements outside the tight tolerance (within the bound). An element whose
gradient is at AdamW's eps (measured: ``enc_layers.0.ln2.bias[8]``, a
gradient of -1.6e-8) moves by m / (sqrt(v) + eps), which turns on the
gradient's last bits: it ended 1.36e-5 from the reference's, one element
of 2.3 M. torch is pinned to one thread, as in ``test_torch_train.py``.
"""
import functools

import pytest
import torch

import test_torch_train as ttrain

ARCH = "whisper-small"
ADAMW_FLIPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP_CASES = [
    # (arch, optimizer, microbatches, compress, dtype), the parameter check
    ((ARCH, "adamw", 1, False, "float32"),
     functools.partial(ttrain.param_check, flips=ADAMW_FLIPS)),
    ((ARCH, "adafactor", 2, True, "float32"), ttrain.param_check),
]


@pytest.mark.parametrize("case,check", STEP_CASES, ids=lambda c: "-".join(
    str(x) for x in c[1:]) if isinstance(c, tuple) else "")
def test_train_step_matches_the_reference(case, check):
    ttrain.check_train_step(case, check_params=check)
