"""Port parity: the reference's single-shard answer paths, the paper's
Table 1 phase split and the one-query LWE encryption (repro_torch vs
repro).

The same numpy-seeded database and keys go through both packages. The
answers are integer (XOR words, int32 partial sums that wrap mod 2^32 in
both), so they must be equal exactly, and the records they reconstruct
must be the database's rows. On the CPU each wrapper takes its kernel's
plain version; the counters show which ran.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dpf as ref_dpf
from repro.core import lwe as ref_lwe
from repro.core import pir as ref_pir
from repro_torch.core import dpf, lwe, pir
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.kernels import ops


# the reference's answer paths, jitted: the same jnp functions, compiled
# once per shape instead of dispatched op by op
REF_ANSWER_XOR = jax.jit(ref_pir.answer_xor)
REF_ANSWER_XOR_BATCH = jax.jit(ref_pir.answer_xor_batch)
REF_ANSWER_ADDITIVE_BATCH = jax.jit(ref_pir.answer_additive_batch)


def _u(t):
    return t.numpy().view(np.uint32)


def _db(n, words=8, seed=1):
    return pir.make_database(np.random.default_rng(seed), n, 4 * words)


def _pairs(alphas, log_n, seed, payload=None):
    """Per-index key pairs, unbatched, from one rng in both packages."""
    r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = [ref_dpf.gen_keys(r_rng, a, log_n, payload=payload)
           for a in alphas]
    port = [dpf.gen_keys(p_rng, a, log_n, payload=payload) for a in alphas]
    return ref, port


@pytest.mark.parametrize("n", [1 << 10, 1000, 1])
def test_answer_xor_matches_reference(n):
    db = _db(n)
    log_n = (n - 1).bit_length()
    alphas = sorted({0, n - 1})
    ref, port = _pairs(alphas, log_n, seed=n)
    t_db = torch.from_numpy(db.view(np.int32))
    ops.reset_counts()
    for a, r, k in zip(alphas, ref, port):
        shares = []
        for p in (0, 1):
            got = pir.answer_xor(t_db, k[p])
            want = np.asarray(REF_ANSWER_XOR(jnp.asarray(db), r[p]))
            assert tuple(got.shape) == (8,)
            np.testing.assert_array_equal(_u(got), want)
            shares.append(got)
        np.testing.assert_array_equal(
            _u(pir.reconstruct_xor(*shares)), db[a])
    # one dpXOR call per answer, each on the plain version here
    assert ops.counts()["dpxor"] == {"launches": 0,
                                     "plain_calls": 2 * len(alphas)}


def test_answer_xor_takes_a_batch_of_one_only():
    db = torch.from_numpy(_db(1 << 6).view(np.int32))
    k0, _ = dpf.gen_keys_batch(np.random.default_rng(2), [1, 2], 6)
    one = pir.answer_xor(db, dpf.map_keys(k0, lambda x: x[:1]))
    assert torch.equal(one, pir.answer_xor(db, dpf.key_at(k0, 0)))
    with pytest.raises(ValueError, match="one query"):
        pir.answer_xor(db, k0)


@pytest.mark.parametrize("n", [1 << 10, 1000])
def test_answer_xor_batch_matches_reference(n):
    db = _db(n, seed=3)
    log_n = (n - 1).bit_length()
    alphas = [5, n - 1, 5, 700 % n]
    ref, port = _pairs(alphas, log_n, seed=30 + n)
    t_db = torch.from_numpy(db.view(np.int32))
    ops.reset_counts()
    shares = []
    for p in (0, 1):
        got = pir.answer_xor_batch(t_db, dpf.stack_keys([k[p]
                                                         for k in port]))
        want = np.asarray(REF_ANSWER_XOR_BATCH(
            jnp.asarray(db), ref_dpf.stack_keys([r[p] for r in ref])))
        np.testing.assert_array_equal(_u(got), want)
        shares.append(got)
    np.testing.assert_array_equal(_u(pir.reconstruct_xor(*shares)),
                                  db[alphas])
    # one dpXOR call for all Q queries of a party
    assert ops.counts()["dpxor"]["plain_calls"] == 2


@pytest.mark.parametrize("n", [1 << 10, 1000])
def test_answer_additive_batch_matches_reference(n):
    db = _db(n, seed=4)
    log_n = (n - 1).bit_length()
    alphas = [0, 333, n - 1, 333]
    one = np.array([1], np.uint32)
    ref, port = _pairs(alphas, log_n, seed=40 + n, payload=one)
    db_bytes = np_words_to_bytes(db)
    t_bytes = torch.from_numpy(db_bytes.view(np.int8))
    ops.reset_counts()
    answers = []
    for p in (0, 1):
        got = pir.answer_additive_batch(
            t_bytes, dpf.stack_keys([k[p] for k in port]))
        want = np.asarray(REF_ANSWER_ADDITIVE_BATCH(
            jnp.asarray(db_bytes.view(np.int8)),
            ref_dpf.stack_keys([r[p] for r in ref])))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        answers.append(got)
    rec = pir.reconstruct_additive(*answers)
    np.testing.assert_array_equal(rec.numpy(), db_bytes[alphas])
    assert ops.counts()["pir_gemm"]["plain_calls"] == 2


@pytest.mark.parametrize("q", [1, 4])
def test_phase_split_matches_reference(q):
    log_n = 9
    db = _db(1 << log_n, seed=5)
    alphas = list(np.random.default_rng(q).integers(0, 1 << log_n, size=q))
    ref, port = _pairs(alphas, log_n, seed=50 + q)
    t_db = torch.from_numpy(db.view(np.int32))
    ops.reset_counts()
    for p in (0, 1):
        keys = dpf.stack_keys([k[p] for k in port])
        r_keys = ref_dpf.stack_keys([r[p] for r in ref])
        bits = pir.phase_eval_bits(keys, log_n)
        r_bits = ref_pir.phase_eval_bits(r_keys, log_n)
        np.testing.assert_array_equal(_u(bits), np.asarray(r_bits))
        got = pir.phase_dpxor(t_db, bits)
        want = ref_pir.phase_dpxor(jnp.asarray(db), r_bits)
        np.testing.assert_array_equal(_u(got), np.asarray(want))
        # the two phases are the batch answer, split
        assert torch.equal(got, pir.answer_xor_batch(t_db, keys))
    assert ops.counts()["dpxor"]["plain_calls"] == 4


@pytest.mark.parametrize("n_items,index", [(1 << 8, 0), (1 << 8, 255),
                                           (1 << 12, 1234)])
def test_encrypt_matches_reference(n_items, index):
    ref_rng, rng = np.random.default_rng(7), np.random.default_rng(7)
    r_ct, r_state = ref_lwe.encrypt(ref_rng, index, n_items,
                                    ref_lwe.params_for(n_items))
    ops.reset_counts()
    ct, state = lwe.encrypt(rng, index, n_items, lwe.params_for(n_items),
                            "cpu")
    assert ops.counts()["lwe_gemm"] == {"launches": 0, "plain_calls": 1}
    assert ct.ct.dtype == torch.int32 and tuple(ct.ct.shape) == (n_items,)
    np.testing.assert_array_equal(ct.ct.numpy(), np.asarray(r_ct.ct))
    assert (ct.log_n, ct.n) == (r_ct.log_n, r_ct.n)
    assert state.index == r_state.index == index
    np.testing.assert_array_equal(state.s, r_state.s)
    # the same draws as the reference, so the rngs stay in step
    assert rng.integers(1 << 30) == ref_rng.integers(1 << 30)


def test_encrypt_is_row_zero_of_the_batch():
    n_items, params = 1 << 8, lwe.params_for(1 << 8)
    ct, state = lwe.encrypt(np.random.default_rng(8), 17, n_items, params,
                            "cpu")
    cts, states = lwe.encrypt_batch(np.random.default_rng(8), [17], n_items,
                                    params, "cpu")
    assert torch.equal(ct.ct, cts.ct[0])
    np.testing.assert_array_equal(state.s, states[0].s)
    with pytest.raises(ValueError, match="out of range"):
        lwe.encrypt(np.random.default_rng(0), n_items, n_items, params, "cpu")
