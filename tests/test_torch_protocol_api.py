"""Port parity: the protocol registry's helpers, the k-server component
bits, ``ExecutionPlan.describe`` and the AES oracle (repro_torch vs
repro).

Keys come from one numpy seed in both packages; bits and AES blocks are
integer, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro.config import PIRConfig as RefPIRConfig
from repro.core import dpf as ref_dpf
from repro.core import protocol as ref_protocol
from repro.crypto import aes_ref as ref_aes
from repro_torch.config import PIRConfig
from repro_torch.core import dpf, protocol
from repro_torch.crypto import aes_ref

LOG_N = 6


def _u(t):
    return t.numpy().view(np.uint32)


def test_available_matches_reference():
    assert protocol.available() == ref_protocol.available()
    assert protocol.available() == tuple(sorted(protocol.available()))
    for name in protocol.available():
        assert protocol.get(name).name == name


@pytest.mark.parametrize("party", [0, 1, 3])
def test_replace_party_matches_reference(party):
    r, _ = ref_dpf.gen_keys(np.random.default_rng(1), 9, LOG_N)
    k, _ = dpf.gen_keys(np.random.default_rng(1), 9, LOG_N)
    r2, k2 = ref_protocol.replace_party(r, party), protocol.replace_party(
        k, party)
    assert k2.party == r2.party == party
    assert k.party == r.party == 0                    # the input unchanged
    assert (k2.log_n, k2.rounds) == (r2.log_n, r2.rounds)
    for name in ("root_seed", "cw_seed", "cw_t"):
        assert getattr(k2, name) is getattr(k, name)  # tensors shared
        np.testing.assert_array_equal(_u(getattr(k2, name)),
                                      np.asarray(getattr(r2, name)))
    assert k2.cw_final is None and r2.cw_final is None


def _k_keys(indices, n_servers=3, seed=5):
    cfg = PIRConfig(n_items=1 << LOG_N, protocol="xor-dpf-k",
                    n_servers=n_servers)
    ref_cfg = RefPIRConfig(**cfg.to_dict())
    r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = [ref_protocol.get("xor-dpf-k").query_gen(r_rng, i, ref_cfg)
           for i in indices]
    port = [protocol.get("xor-dpf-k").query_gen(p_rng, i, cfg)
            for i in indices]
    return ref, port


@pytest.mark.parametrize("block,log_range", [(0, LOG_N), (1, 4), (5, 3)])
def test_component_bits_match_reference(block, log_range):
    ref, port = _k_keys([17, 40])
    for r_parties, p_parties in zip(ref, port):
        for r, k in zip(r_parties, p_parties):
            got = protocol._component_bits(k, block, log_range)
            want = np.asarray(ref_protocol._component_bits(r, block,
                                                           log_range))
            assert tuple(got.shape) == (1 << log_range,)
            np.testing.assert_array_equal(_u(got), want)


def test_component_bits_fold_to_the_index():
    indices = [0, 17, 63]
    _, port = _k_keys(indices, n_servers=4, seed=6)
    for i, parties in zip(indices, port):
        fold = protocol._component_bits(parties[0], 0, LOG_N)
        for k in parties[1:]:
            fold = fold ^ protocol._component_bits(k, 0, LOG_N)
        assert fold.sum().item() == 1 and fold[i].item() == 1


def test_component_bits_batch_rows_are_the_one_query_form():
    _, port = _k_keys([3, 4, 60], seed=7)
    for p in range(3):
        batch = dpf.stack_keys([parties[p] for parties in port])
        rows = protocol._component_bits_batch(batch, 0, LOG_N)
        for q, parties in enumerate(port):
            assert torch.equal(rows[q], protocol._component_bits(
                parties[p], 0, LOG_N))


@pytest.mark.parametrize("fields", [
    {},
    {"expand": "fused", "scan": "cuda", "chunk_log": 10, "tile_r": 512,
     "provenance": "tuned"},
    {"expand": "materialize", "scan": "torch", "provenance": "forced"},
    {"collective": "butterfly"}])
def test_describe_matches_reference(fields):
    got = protocol.ExecutionPlan(**fields).describe()
    want = ref_protocol.ExecutionPlan(**fields).describe()
    # the reference's Pallas tiles: not in the port
    assert set(want) - set(got) == {"tile_q", "tile_l", "depth"}
    if "scan" not in fields:      # the default scans' names differ
        want["scan"] = "torch"
        want["name"] = f"{want['expand']}/torch"
    assert got == {k: want[k] for k in got}


def test_protocol_base_defaults_match_reference():
    cfg = PIRConfig(n_items=1 << LOG_N)
    ref_cfg = RefPIRConfig(**cfg.to_dict())
    proto, ref = protocol.get("xor-dpf-2"), ref_protocol.get("xor-dpf-2")
    keys, state = proto.query_gen_full(np.random.default_rng(2), 5, cfg)
    r_keys, r_state = ref.query_gen_full(np.random.default_rng(2), 5, ref_cfg)
    assert state is None and r_state is None
    for k, r in zip(keys, r_keys):
        np.testing.assert_array_equal(_u(k.root_seed),
                                      np.asarray(r.root_seed))
    for p in (proto, ref):
        with pytest.raises(NotImplementedError, match="has no hint"):
            p.hint_builder(cfg)


# ---------------------------------------------------------------------------
# the AES oracle
# ---------------------------------------------------------------------------

def test_aes128_fips197_vector():
    key = np.arange(16, dtype=np.uint8)
    pt = np.array([0x00, 0x11, 0x22, 0x33, 0x44, 0x55, 0x66, 0x77, 0x88,
                   0x99, 0xAA, 0xBB, 0xCC, 0xDD, 0xEE, 0xFF], np.uint8)
    ct = aes_ref.encrypt_block(pt, key)
    assert ct.tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    np.testing.assert_array_equal(aes_ref.expand_key(key),
                                  ref_aes.expand_key(key))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aes_oracle_matches_reference(seed):
    rng = np.random.default_rng(seed)
    key, pt, s = (rng.integers(0, 256, size=16, dtype=np.uint8)
                  for _ in range(3))
    np.testing.assert_array_equal(aes_ref.encrypt_block(pt, key),
                                  ref_aes.encrypt_block(pt, key))
    got, want = aes_ref.aes_ggm_double(s), ref_aes.aes_ggm_double(s)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[1], got[3]) == (want[1], want[3])
    assert not np.array_equal(got[0], got[2])
