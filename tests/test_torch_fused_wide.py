"""Port parity of the fused expand + select-XOR scan at rows wider than 32
words, the widths the kernel's wide instance serves on the card
(``csrc/fused_scan_xor.cu fused_scan_xor_wide_kernel``).

On the CPU ``ops.fused_scan_xor`` takes its plain version
(``fused_scan_xor_plain``); here it is held against the reference's
``repro.kernels.ops.fused_scan_xor``, the Pallas kernel run in interpret
mode as tests/test_fused_scan.py runs it, on the same seeded numpy DB and
keys: 33 words (132-byte records, not whole 16-byte words), 1,280 words
(qwen3-4b's 5,120-byte embedding rows) and 3,584 words (deepseek-v3's and
llava-next-34b's 14,336-byte rows), batches of 1, 4 and 33 (two query
groups of the wide instance), chunk logs 0, 1 and 5, and shards that start
past block 0. Integer-exact: every comparison is array equality. The
kernel itself is held against the same plain version on the card
(tests/test_torch_kernels.py ``test_fused_xor_wide_kernel_on_the_card``,
chip_smoke.py's ``check_widths`` and ``*_kernels`` phases).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dpf as ref_dpf
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import dpf
from repro_torch.kernels import fused_scan as kf
from repro_torch.kernels import ops


def _keys(rng, q, log_n):
    keys = ref_dpf.stack_keys([ref_dpf.gen_keys(rng, int(i), log_n)[q % 2]
                               for i in rng.integers(0, 1 << log_n, size=q)])
    port = convert.keys_from_reference(
        party=keys.party, log_n=keys.log_n,
        root_seed=np.asarray(keys.root_seed), cw_seed=np.asarray(keys.cw_seed),
        cw_t=np.asarray(keys.cw_t), rounds=keys.rounds)
    return keys, port


# (words, queries, chunk log, rows of the shard as 2^log, its start block):
# every width, batch and chunk log at least once, two shards past block 0
CASES = [
    (33, 1, 0, 6, 0),
    (33, 33, 5, 6, 0),
    (1280, 4, 1, 5, 0),
    (1280, 33, 0, 4, 3),
    (3584, 4, 5, 6, 0),
    (3584, 1, 1, 5, 1),
]


@pytest.mark.parametrize("words,q,clog,log_local,block", CASES)
def test_wide_rows_match_the_reference_kernel(words, q, clog, log_local,
                                              block):
    rng = np.random.default_rng(words + 7 * q + clog)
    rows = 1 << log_local
    log_n = log_local + (block.bit_length() if block else 0)
    db = rng.integers(0, 1 << 32, size=(rows, words), dtype=np.uint32)
    keys, port = _keys(rng, q, log_n)
    lvl0 = log_n - clog

    roots, t_roots = ref_dpf.eval_roots_batch(keys, block, log_local, clog)
    want = np.asarray(ref_ops.fused_scan_xor(
        jnp.asarray(db), roots, t_roots, keys.cw_seed[:, lvl0:, :],
        keys.cw_t[:, lvl0:, :], tile_r=rows))

    p_roots, p_t = dpf.eval_roots_batch(port, block, log_local, clog)
    before = ops.counts()["fused_scan_xor"]
    got = ops.fused_scan_xor(convert.database_from_reference(db), p_roots,
                             p_t, port.cw_seed[:, lvl0:, :],
                             port.cw_t[:, lvl0:, :], rounds=port.rounds)
    after = ops.counts()["fused_scan_xor"]
    assert got.shape == (q, words) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the CPU path is the plain version, never a launch
    assert after["plain_calls"] == before["plain_calls"] + 1
    assert after["launches"] == before["launches"]
    assert kf.instance_xor(words, queries=q).startswith(
        "26fused_scan_xor_wide_kernel")
