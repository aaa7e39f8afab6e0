"""Port parity: full-domain DPF evaluation and the leaf outputs
(``eval_all``, ``leaf_bits``, ``leaf_words``; repro_torch vs repro).

Keys come from the same numpy seed in both packages, so leaves, bits and
word shares must be equal bit for bit, as ``tests/test_dpf.py`` holds the
reference's to their algebra.
"""
import numpy as np
import pytest
import torch

from repro.core import dpf as ref_dpf
from repro_torch.core import dpf


def _u(t):
    return t.numpy().view(np.uint32)


def _keys(alpha, log_n, seed, payload=None):
    ref = ref_dpf.gen_keys(np.random.default_rng(seed), alpha, log_n,
                           payload=payload)
    port = dpf.gen_keys(np.random.default_rng(seed), alpha, log_n,
                        payload=payload)
    return ref, port


@pytest.mark.parametrize("log_n,alpha", [(1, 0), (5, 17), (8, 255)])
def test_eval_all_matches_reference(log_n, alpha):
    ref, port = _keys(alpha, log_n, seed=log_n)
    for r, k in zip(ref, port):
        seeds, t = dpf.eval_all(k)
        r_seeds, r_t = ref_dpf.eval_all(r)
        assert tuple(seeds.shape) == (1 << log_n, 4)
        np.testing.assert_array_equal(_u(seeds), np.asarray(r_seeds))
        np.testing.assert_array_equal(_u(t), np.asarray(r_t))
        bits = dpf.leaf_bits(t)
        assert bits.dtype == torch.int32
        np.testing.assert_array_equal(_u(bits),
                                      np.asarray(ref_dpf.leaf_bits(r_t)))
    onehot = (dpf.leaf_bits(dpf.eval_all(port[0])[1])
              ^ dpf.leaf_bits(dpf.eval_all(port[1])[1])).numpy()
    assert onehot.sum() == 1 and onehot[alpha] == 1


def test_eval_all_batched_rows_equal_single_keys():
    alphas = [3, 60, 61]
    k0, _ = dpf.gen_keys_batch(np.random.default_rng(4), alphas, 6)
    seeds, t = dpf.eval_all(k0)
    assert tuple(t.shape) == (3, 64)
    for i in range(3):
        s_i, t_i = dpf.eval_all(dpf.key_at(k0, i))
        assert torch.equal(seeds[i], s_i) and torch.equal(t[i], t_i)


def _beta(n_words, seed):
    beta = np.random.default_rng(seed).integers(0, 1 << 32, size=n_words,
                                                dtype=np.uint32)
    beta[0] = 0x7FFFFFFF                  # sums near 2^31 wrap in int32
    return beta


@pytest.mark.parametrize("log_n,alpha,n_words", [(1, 1, 1), (4, 9, 3),
                                                 (7, 100, 8), (6, 0, 17)])
def test_leaf_words_match_reference(log_n, alpha, n_words):
    beta = _beta(n_words, seed=alpha)
    ref, port = _keys(alpha, log_n, seed=log_n + 1, payload=beta)
    shares = []
    for r, k in zip(ref, port):
        seeds, t = dpf.eval_all(k)
        got = dpf.leaf_words(k, seeds, t, n_words)
        r_seeds, r_t = ref_dpf.eval_all(r)
        want = np.asarray(ref_dpf.leaf_words(r, r_seeds, r_t, n_words))
        assert tuple(got.shape) == (1 << log_n, n_words)
        np.testing.assert_array_equal(_u(got), want)
        shares.append(_u(got).astype(np.uint64))
    total = (shares[0] + shares[1]) % (1 << 32)
    expect = np.zeros(((1 << log_n), n_words), np.uint64)
    expect[alpha] = beta
    np.testing.assert_array_equal(total, expect)


def test_leaf_words_of_a_batch():
    alphas, beta = [2, 30], _beta(4, seed=8)
    pair = dpf.gen_keys_batch(np.random.default_rng(6), alphas, 5,
                              payload=beta)
    for k in pair:
        seeds, t = dpf.eval_all(k)
        got = dpf.leaf_words(k, seeds, t, 4)
        for i in range(2):
            one = dpf.key_at(k, i)
            s_i, t_i = dpf.eval_all(one)
            assert torch.equal(got[i], dpf.leaf_words(one, s_i, t_i, 4))


def test_leaf_words_party_one_negates_near_two_to_31():
    """Party 1's share is (~x) + 1 in int32: at x = -2^31 it wraps to
    itself, as u32 negation mod 2^32 does."""
    beta = np.array([0x80000000, 1], np.uint32)
    _, port = _keys(5, 4, seed=12, payload=beta)
    k1 = port[1]
    seeds, t = dpf.eval_all(k1)
    got = _u(dpf.leaf_words(k1, seeds, t, 2)).astype(np.uint64)
    pos = dpf.leaf_words(dpf.DPFKey(**{**k1.__dict__, "party": 0}),
                         seeds, t, 2)
    want = (np.uint64(1 << 32) - _u(pos).astype(np.uint64)) % (1 << 32)
    np.testing.assert_array_equal(got, want)


def test_leaf_words_needs_a_payload():
    ref, port = _keys(3, 4, seed=2)
    r_seeds, r_t = ref_dpf.eval_all(ref[0])
    seeds, t = dpf.eval_all(port[0])
    with pytest.raises(ValueError, match="without a payload"):
        ref_dpf.leaf_words(ref[0], r_seeds, r_t, 2)
    with pytest.raises(ValueError, match="without a payload"):
        dpf.leaf_words(port[0], seeds, t, 2)
