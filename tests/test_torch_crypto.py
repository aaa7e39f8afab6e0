"""Port parity: ChaCha PRG and word packing (repro_torch vs repro).

Integer-exact, so every comparison is array equality. Inputs come from a
numpy seed and go to both packages.
"""
import numpy as np
import pytest
import torch

from repro.crypto import chacha as ref_chacha
from repro.crypto import packing as ref_packing
from repro_torch.crypto import chacha, packing

RNG = np.random.default_rng(101)
KEYS = RNG.integers(0, 1 << 32, size=(3, 5, 4), dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("rounds", [8, 12, 20])
@pytest.mark.parametrize("counter", [0, 1, 2])
def test_chacha_block_matches_reference(rounds, counter):
    want = np.asarray(ref_chacha.chacha_block(KEYS, counter=counter,
                                              rounds=rounds))
    got = _u(chacha.chacha_block(_t(KEYS), counter=counter, rounds=rounds))
    np.testing.assert_array_equal(got, want)


def test_chacha_block_top_counter_word():
    """Counters >= 2^31 keep their u32 bit pattern in the int32 state."""
    want = np.asarray(ref_chacha.chacha_block(KEYS[0], counter=0xFFFFFFFF))
    got = _u(chacha.chacha_block(_t(KEYS[0]), counter=0xFFFFFFFF))
    np.testing.assert_array_equal(got, want)


def test_chacha_odd_rounds_rejected():
    with pytest.raises(ValueError):
        chacha.chacha_block(_t(KEYS), rounds=7)


def test_ggm_double_matches_reference():
    want = [np.asarray(x) for x in ref_chacha.ggm_double(KEYS[0])]
    got = [_u(x) for x in chacha.ggm_double(_t(KEYS[0]))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_words", [1, 16, 20])
def test_prg_bits_matches_reference(n_words):
    want = np.asarray(ref_chacha.prg_bits(KEYS[1], n_words))
    got = _u(chacha.prg_bits(_t(KEYS[1]), n_words))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounds", [8, 12, 20])
@pytest.mark.parametrize("counter", [0, 1, 0xFFFFFFFF])
def test_chacha_block_np_matches_reference(rounds, counter):
    """The host PRG of the client's keygen, on u32 arrays."""
    want = np.asarray(ref_chacha.chacha_block(KEYS, counter=counter,
                                              rounds=rounds))
    got = chacha.chacha_block_np(KEYS, counter=counter, rounds=rounds)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_chacha_np_odd_rounds_rejected():
    with pytest.raises(ValueError):
        chacha.chacha_block_np(KEYS, rounds=7)


def test_ggm_double_np_matches_reference():
    want = [np.asarray(x) for x in ref_chacha.ggm_double(KEYS[0])]
    got = chacha.ggm_double_np(KEYS[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_words", [1, 16, 20])
def test_prg_bits_np_matches_reference(n_words):
    want = np.asarray(ref_chacha.prg_bits(KEYS[1], n_words))
    np.testing.assert_array_equal(chacha.prg_bits_np(KEYS[1], n_words), want)


def test_constants_match_reference():
    np.testing.assert_array_equal(chacha.SIGMA, ref_chacha.SIGMA)
    assert chacha.PRG_ROUNDS == ref_chacha.PRG_ROUNDS


def test_words_round_trip_keeps_bits():
    words = RNG.integers(0, 1 << 32, size=(7, 8), dtype=np.uint32)
    t = packing.words_to_tensor(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(packing.tensor_to_words(t), words)


def test_words_to_bytes_matches_reference():
    words = RNG.integers(0, 1 << 32, size=(4, 8), dtype=np.uint32)
    np.testing.assert_array_equal(packing.np_words_to_bytes(words),
                                  ref_packing.np_words_to_bytes(words))
