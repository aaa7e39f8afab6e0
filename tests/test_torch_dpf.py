"""Port parity: DPF key generation and evaluation (repro_torch vs repro).

Keys from the same numpy seed must be equal field by field, and the
batched evaluators must return the reference's vmapped outputs exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import dpf as ref_dpf
from repro_torch.core import dpf

LOG_N = 7
ALPHAS = [0, 5, 77, 127]


def _u(t):
    return t.numpy().view(np.uint32)


def _ref_keys():
    rng = np.random.default_rng(9)
    return [ref_dpf.gen_keys(rng, a, LOG_N) for a in ALPHAS]


@pytest.fixture(scope="module")
def batched():
    """Batched reference keys per party, drawn in sequence from one rng,
    and the port's batch drawn from the same seed."""
    ref = _ref_keys()
    ref_b = [ref_dpf.stack_keys([k[p] for k in ref]) for p in (0, 1)]
    port = dpf.gen_keys_batch(np.random.default_rng(9), ALPHAS, LOG_N)
    return ref_b, port


@pytest.mark.parametrize("party", [0, 1])
def test_gen_keys_batch_field_by_field(batched, party):
    ref_b, port = batched
    r, k = ref_b[party], port[party]
    assert (k.party, k.log_n, k.rounds) == (r.party, r.log_n, r.rounds)
    for name in ("root_seed", "cw_seed", "cw_t"):
        np.testing.assert_array_equal(_u(getattr(k, name)),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)
    assert k.cw_final is None and r.cw_final is None


@pytest.mark.parametrize("log_n,alpha", [(1, 1), (4, 9), (9, 300)])
def test_gen_keys_single_field_by_field(log_n, alpha):
    r0, r1 = ref_dpf.gen_keys(np.random.default_rng(log_n), alpha, log_n)
    k0, k1 = dpf.gen_keys(np.random.default_rng(log_n), alpha, log_n)
    for r, k in ((r0, k0), (r1, k1)):
        assert k.root_seed.shape == (4,)
        for name in ("root_seed", "cw_seed", "cw_t"):
            np.testing.assert_array_equal(_u(getattr(k, name)),
                                          np.asarray(getattr(r, name)))


def test_gen_keys_chacha8_matches_reference():
    r0, _ = ref_dpf.gen_keys(np.random.default_rng(3), 6, 5, rounds=8)
    k0, _ = dpf.gen_keys(np.random.default_rng(3), 6, 5, rounds=8)
    np.testing.assert_array_equal(_u(k0.cw_seed), np.asarray(r0.cw_seed))


def test_gen_keys_rejects_out_of_domain():
    with pytest.raises(ValueError, match="out of domain"):
        dpf.gen_keys(np.random.default_rng(0), 1 << LOG_N, LOG_N)


@pytest.mark.parametrize("start_block,log_range", [(0, LOG_N), (3, 5), (1, 3)])
def test_eval_bits_batch_matches_reference(batched, start_block, log_range):
    ref_b, port = batched
    for p in (0, 1):
        want = np.asarray(ref_dpf.eval_bits_batch(ref_b[p], start_block,
                                                  log_range))
        got = _u(dpf.eval_bits_batch(port[p], start_block, log_range))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start_block,log_range,stop_log",
                         [(0, LOG_N, 3), (2, 5, 5), (1, 6, 0)])
def test_eval_roots_batch_matches_reference(batched, start_block, log_range,
                                            stop_log):
    ref_b, port = batched
    want_s, want_t = ref_dpf.eval_roots_batch(ref_b[1], start_block,
                                              log_range, stop_log)
    got_s, got_t = dpf.eval_roots_batch(port[1], start_block, log_range,
                                        stop_log)
    np.testing.assert_array_equal(_u(got_s), np.asarray(want_s))
    np.testing.assert_array_equal(_u(got_t), np.asarray(want_t))


def test_point_function_property(batched):
    _, (k0, k1) = batched
    onehot = _u(dpf.eval_bits_batch(k0, 0, LOG_N)
                ^ dpf.eval_bits_batch(k1, 0, LOG_N))
    want = np.zeros((len(ALPHAS), 1 << LOG_N), np.uint32)
    want[np.arange(len(ALPHAS)), ALPHAS] = 1
    np.testing.assert_array_equal(onehot, want)


def test_eval_range_rejects_bad_ranges(batched):
    _, (k0, _) = batched
    with pytest.raises(ValueError):
        dpf.eval_range(k0, 0, LOG_N + 1)
    with pytest.raises(ValueError):
        dpf.eval_to_depth(k0, 0, 4, 5)


def test_stack_and_key_at_round_trip(batched):
    _, (k0, _) = batched
    singles = [dpf.key_at(k0, i) for i in range(len(ALPHAS))]
    again = dpf.stack_keys(singles)
    for name in ("root_seed", "cw_seed", "cw_t"):
        assert torch.equal(getattr(again, name), getattr(k0, name))


def test_stack_keys_rejects_mixed_parties(batched):
    _, (k0, k1) = batched
    with pytest.raises(ValueError):
        dpf.stack_keys([dpf.key_at(k0, 0), dpf.key_at(k1, 0)])


def test_pad_keys_replicates_last_key_like_reference(batched):
    ref_b, port = batched
    want = ref_dpf.pad_keys(ref_b[0], 7)
    got = dpf.pad_keys(port[0], 7)
    assert dpf.n_queries_of(got) == 7
    for name in ("root_seed", "cw_seed", "cw_t"):
        np.testing.assert_array_equal(_u(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    assert dpf.pad_keys(port[0], len(ALPHAS)) is port[0]
    with pytest.raises(ValueError):
        dpf.pad_keys(port[0], 2)
