"""Port: the VLM family's train step (llava-next-34b ``SMOKE``, the
pipeline's ``prefix_embeds`` beside its tokens) against the reference's
``make_train_step`` on the CPU: AdamW in one microbatch and Adafactor with
``compress_grads`` in two (each microbatch its own slice of the prefix),
in float32 and bfloat16, three steps each from the reference's weights
(``test_torch_train.check_train_step``). Tolerances are
``tests/test_torch_train.py``'s: float32 losses rtol 1e-5, parameters
rtol 1e-4 / atol 1e-5 (with compression at most 2e-3 of the elements
outside, none by more than 2^-8 of the leaf's largest magnitude plus 2 x
lr per step); bfloat16 losses atol 2e-2, parameters within one bf16 ulp
but for at most 10 % of the elements; optimizer state within 1e-3
(float32) / 0.1 (bfloat16) of the reference's by the norm of the
difference. torch is pinned to one thread, as in ``test_torch_train.py``.
"""
import pytest
import torch

import test_torch_train as ttrain

ARCH = "llava-next-34b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP_CASES = [
    # (arch, optimizer, microbatches, compress, dtype): AdamW in one
    # microbatch, Adafactor with compression in two, each in float32 and
    # bfloat16
    (ARCH, "adamw", 1, False, "float32"),
    (ARCH, "adafactor", 2, True, "float32"),
    (ARCH, "adamw", 1, False, "bfloat16"),
    (ARCH, "adafactor", 2, True, "bfloat16"),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(
    str(x) for x in c[1:]))
def test_train_step_matches_the_reference(case):
    ttrain.check_train_step(case)
