"""Port parity: the GGM level kernel's path against the reference.

``ops.ggm_expand`` (on the CPU, the plain version beside the CUDA kernel)
against the reference's ``ops.ggm_expand`` in Pallas interpret mode (as
tests/test_kernels.py runs it) and its jnp oracle ``ref.ggm_expand_ref``;
``ops.ggm_eval_leaves`` against the reference's full-domain DPF evaluation.
Integer-exact: every comparison is array equality. The CUDA kernel itself
is held against the same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dpf as ref_dpf
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core import dpf
from repro_torch.crypto.chacha import ggm_double
from repro_torch.kernels import ggm_expand as kg
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


def _level(n):
    """One level's operands as numpy u32: seeds, t, cw_seed, cw_t."""
    return (RNG.integers(0, 1 << 32, size=(n, 4), dtype=np.uint32),
            RNG.integers(0, 2, size=(n,), dtype=np.uint32),
            RNG.integers(0, 1 << 32, size=(4,), dtype=np.uint32),
            RNG.integers(0, 2, size=(2,), dtype=np.uint32))


def _port(args, **kw):
    children, t = ops.ggm_expand(*(_t(a) for a in args), **kw)
    return _u(children), _u(t)


@pytest.mark.parametrize("n,rounds,tile", [
    (1, 12, 65536),
    (4, 12, 65536),
    (64, 12, 65536),
    (256, 2, 64),          # grid = 4 in the reference (its index maps)
])
def test_ggm_expand_matches_reference_kernel(n, rounds, tile):
    args = _level(n)
    want_c, want_t = ref_ops.ggm_expand(*(jnp.asarray(a) for a in args),
                                        rounds=rounds, tile=tile)
    got_c, got_t = _port(args, rounds=rounds, tile=tile)
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    np.testing.assert_array_equal(got_t, np.asarray(want_t))


@pytest.mark.parametrize("n,rounds", [(1000, 12), (4096, 12), (4096, 8),
                                      (777, 20)])
def test_ggm_expand_matches_reference_oracle(n, rounds):
    args = _level(n)
    want_c, want_t = ref_ref.ggm_expand_ref(*(jnp.asarray(a) for a in args),
                                            rounds=rounds)
    got_c, got_t = _port(args, rounds=rounds)
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    np.testing.assert_array_equal(got_t, np.asarray(want_t))


def test_ggm_expand_children_are_leaf_major_interleaved():
    """Row 2j is node j's left child and row 2j + 1 its right, each XOR
    the correction masked by node j's t; the t bits interleave alike."""
    seeds, t, cw_s, cw_t = (_t(a) for a in _level(33))
    children, t_out = ops.ggm_expand(seeds, t, cw_s, cw_t)
    s_l, t_l, s_r, t_r = ggm_double(seeds)
    mask = -t[:, None] & cw_s[None, :]
    assert children.shape == (66, 4) and t_out.shape == (66,)
    assert torch.equal(children[0::2], s_l ^ mask)
    assert torch.equal(children[1::2], s_r ^ mask)
    assert torch.equal(t_out[0::2], t_l ^ (t & cw_t[0]))
    assert torch.equal(t_out[1::2], t_r ^ (t & cw_t[1]))
    # a node with t = 0 takes no correction
    zero = (t == 0).nonzero()[0, 0]
    assert torch.equal(children[2 * zero], s_l[zero])


@pytest.mark.parametrize("party", [0, 1])
def test_ggm_eval_leaves_matches_reference_dpf(party):
    """The level kernel's full-domain chain (log_n launches) == the
    reference's ``core.dpf.eval_all`` of the same key (same rng draws)."""
    log_n, alpha = 6, 21
    ref_key = ref_dpf.gen_keys(np.random.default_rng(5), alpha, log_n)[party]
    key = dpf.gen_keys(np.random.default_rng(5), alpha, log_n)[party]
    want_s, want_t = ref_dpf.eval_all(ref_key)
    ops.reset_counts()
    seeds, t = ops.ggm_eval_leaves(key.root_seed, key.party, key.cw_seed,
                                   key.cw_t, log_n, rounds=key.rounds)
    assert ops.counts()["ggm_expand"] == {"launches": 0,
                                          "plain_calls": log_n}
    np.testing.assert_array_equal(_u(seeds), np.asarray(want_s))
    np.testing.assert_array_equal(_u(t), np.asarray(want_t))
    # the leaf bits equal the port's own batched evaluation too
    assert torch.equal(t, dpf.eval_bits_batch(dpf.stack_keys([key]), 0,
                                              log_n)[0])


def test_ggm_eval_leaves_pair_selects_alpha():
    """t0 XOR t1 over the two keys' leaves is the one-hot of alpha."""
    log_n, alpha = 7, 100
    k0, k1 = dpf.gen_keys(np.random.default_rng(9), alpha, log_n)
    t0 = ops.ggm_eval_leaves(k0.root_seed, 0, k0.cw_seed, k0.cw_t, log_n)[1]
    t1 = ops.ggm_eval_leaves(k1.root_seed, 1, k1.cw_seed, k1.cw_t, log_n)[1]
    want = torch.zeros(1 << log_n, dtype=torch.int32)
    want[alpha] = 1
    assert torch.equal(t0 ^ t1, want)


@pytest.mark.parametrize("n,tile,want", [
    (1 << 24, 256, 256), (1 << 24, 4096, 1024), (1000, 256, 250),
    (7, 256, 7), (1, 128, 1), (96, 64, 48)])
def test_block_size_is_a_legal_divisor(n, tile, want):
    assert kg.block_for(n, tile) == want


def test_cuda_op_refuses_cpu_tensors():
    """The registered op runs only on the card; the CPU route is the
    wrapper's plain version, never a silent fallback inside the op."""
    seeds, t, cw_s, cw_t = (_t(a) for a in _level(8))
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.ops.repro_torch.ggm_expand(seeds, t, cw_s, cw_t, 12, 256)


@pytest.mark.parametrize("bad", ["seeds_dtype", "t_dtype", "seeds_shape",
                                 "t_shape", "cw_seed_shape", "cw_t_shape"])
def test_wrapper_refuses_bad_operands(bad):
    seeds, t, cw_s, cw_t = (_t(a) for a in _level(8))
    if bad == "seeds_dtype":
        seeds = seeds.to(torch.int64)
    elif bad == "t_dtype":
        t = t.to(torch.uint8)
    elif bad == "seeds_shape":
        seeds = seeds[:, :3]
    elif bad == "t_shape":
        t = t[:7]
    elif bad == "cw_seed_shape":
        cw_s = cw_s[:2]
    else:
        cw_t = torch.cat([cw_t, cw_t])
    err = TypeError if bad.endswith("dtype") else ValueError
    ops.reset_counts()
    with pytest.raises(err):
        ops.ggm_expand(seeds, t, cw_s, cw_t)
    assert ops.counts()["ggm_expand"]["plain_calls"] == 0


def test_ref_names_the_plain_version():
    assert ref.ggm_expand_ref is kg.ggm_expand_plain
    assert ops.COUNTS["ggm_expand"] is kg.count
