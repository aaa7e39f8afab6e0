"""Port parity: the k-server XOR scheme (``xor-dpf-k``), repro_torch vs repro.

Keys from one numpy seed equal the reference's (batch and single, the
same rng draws per index), every party's answer equals the reference's
under each plan pair (the Pallas bodies in interpret mode, the port's
plain versions), and ``MultiServerPIR`` returns the database's records.
Integer-exact: every comparison is array equality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import PIRConfig as RefPIRConfig
from repro.core import pir as ref_pir
from repro.core import protocol as ref_protocol
from repro.engine.tuner import heuristic_plan
from repro_torch import convert
from repro_torch.config import PIRConfig
from repro_torch.configs import pir as configs
from repro_torch.core import dpf, pir, protocol
from repro_torch.kernels import ops
from repro_torch.runtime.serve_loop import MultiServerPIR, TwoServerPIR

LOG_N = 7
IDXS = [3, 100, 127]
CHUNK_LOG = 4
TILE_R = 16

#: port plan -> the reference plan it must agree with
PLAN_PAIRS = {
    ("materialize", "torch"): ("materialize", "jnp"),
    ("materialize", "cuda"): ("materialize", "pallas"),
    ("fused", "torch"): ("fused", "jnp"),
    ("fused-cuda", "cuda"): ("fused-pallas", "pallas"),
}


def _u(t):
    return t.numpy().view(np.uint32)


def _cfgs(k, log_n=LOG_N):
    spec = dict(n_items=1 << log_n, item_bytes=32, protocol="xor-dpf-k",
                n_servers=k)
    return PIRConfig(**spec), RefPIRConfig(**spec)


def _port_keys(k):
    return convert.keys_from_reference(
        party=k.party, log_n=k.log_n, root_seed=np.asarray(k.root_seed),
        cw_seed=np.asarray(k.cw_seed), cw_t=np.asarray(k.cw_t),
        rounds=k.rounds)


def _assert_keys_equal(got, want):
    assert (got.party, got.log_n, got.rounds) == \
        (want.party, want.log_n, want.rounds)
    for name in ("root_seed", "cw_seed", "cw_t"):
        np.testing.assert_array_equal(_u(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.cw_final is None and want.cw_final is None


@pytest.fixture(scope="module")
def k3():
    """Reference and port batches from one seed, and a DB."""
    cfg, ref_cfg = _cfgs(3)
    ref = ref_pir.batch_queries(np.random.default_rng(7), IDXS, ref_cfg)
    port = protocol.get("xor-dpf-k").query_gen_batch(
        np.random.default_rng(7), IDXS, cfg)
    db = np.random.default_rng(8).integers(0, 1 << 32,
                                           size=(cfg.n_items, 8),
                                           dtype=np.uint32)
    return cfg, ref_cfg, ref, port, db


@pytest.mark.parametrize("party", [0, 1, 2])
def test_query_gen_batch_equals_reference(k3, party):
    _, _, ref, port, _ = k3
    assert len(port) == len(ref) == 3
    assert port[party].root_seed.shape == (len(IDXS), 3 if party < 2 else 2,
                                           4)
    _assert_keys_equal(port[party], ref[party])


def test_query_gen_batch_draws_like_one_query_gen_per_index():
    """Per index: the DPF pair's two roots, then k mask seeds; the
    generator ends where the reference's per-index calls leave it."""
    cfg, ref_cfg = _cfgs(4, log_n=5)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    ref = ref_pir.batch_queries(a, [1, 30], ref_cfg)
    port = protocol.get("xor-dpf-k").query_gen_batch(b, [1, 30], cfg)
    for r, p in zip(ref, port):
        _assert_keys_equal(p, r)
    assert a.integers(1 << 30) == b.integers(1 << 30)


def test_query_gen_single_equals_reference():
    cfg, ref_cfg = _cfgs(3, log_n=6)
    ref = ref_protocol.get("xor-dpf-k").query_gen(np.random.default_rng(4),
                                                  42, ref_cfg)
    port = protocol.get("xor-dpf-k").query_gen(np.random.default_rng(4), 42,
                                               cfg)
    for r, p in zip(ref, port):
        assert p.root_seed.dim() == 2          # [C, 4]: one query
        _assert_keys_equal(p, r)


@pytest.mark.parametrize("expand,scan", sorted(PLAN_PAIRS))
def test_k3_answer_local_matches_reference(k3, expand, scan):
    _, _, ref, _, db = k3
    ref_plan = ref_protocol.ExecutionPlan(
        *PLAN_PAIRS[(expand, scan)], chunk_log=CHUNK_LOG, tile_r=TILE_R)
    plan = protocol.ExecutionPlan(expand, scan, chunk_log=CHUNK_LOG,
                                  tile_r=TILE_R)
    ref_proto = ref_protocol.get("xor-dpf-k")
    proto = protocol.get("xor-dpf-k")
    got = []
    for rk in ref:
        want = np.asarray(ref_proto.answer_local(jnp.asarray(db), rk, 0,
                                                 LOG_N, ref_plan))
        got.append(proto.answer_local(convert.database_from_reference(db),
                                      _port_keys(rk), 0, LOG_N, plan))
        np.testing.assert_array_equal(_u(got[-1]), want)
    np.testing.assert_array_equal(_u(proto.reconstruct(got)), db[IDXS])


def test_k3_fused_cuda_shard_matches_reference(k3):
    """A shard with start_block != 0 under the fused kernel's plan."""
    _, _, ref, _, db = k3
    log_local, blk = LOG_N - 2, 3
    shard = db[blk << log_local:(blk + 1) << log_local]
    ref_plan = ref_protocol.ExecutionPlan("fused-pallas", "pallas",
                                          chunk_log=2, tile_r=8)
    plan = protocol.ExecutionPlan("fused-cuda", "cuda", chunk_log=2,
                                  tile_r=8)
    want = np.asarray(ref_protocol.get("xor-dpf-k").answer_local(
        jnp.asarray(shard), ref[2], blk, log_local, ref_plan))
    got = protocol.get("xor-dpf-k").answer_local(
        convert.database_from_reference(shard), _port_keys(ref[2]), blk,
        log_local, plan)
    np.testing.assert_array_equal(_u(got), want)


def test_k3_fused_cuda_flattens_components_into_the_kernel(k3):
    """The fused plan runs the XOR kernel's plain version once, on Q*C
    pseudo-queries, and no other kernel."""
    _, _, _, port, db = k3
    ops.reset_counts()
    out = protocol.get("xor-dpf-k").answer_local(
        convert.database_from_reference(db), port[0], 0, LOG_N,
        protocol.ExecutionPlan("fused-cuda", "cuda"))
    assert out.shape == (len(IDXS), 8)
    assert ops.counts()["fused_scan_xor"] == {"launches": 0,
                                              "plain_calls": 1}
    assert sum(c["plain_calls"] for c in ops.counts().values()) == 1


def test_component_bits_fold_to_the_point_function(k3):
    _, _, _, port, _ = k3
    bits = [protocol._component_bits_batch(k, 0, LOG_N) for k in port]
    onehot = np.zeros((len(IDXS), 1 << LOG_N), np.int32)
    onehot[np.arange(len(IDXS)), IDXS] = 1
    np.testing.assert_array_equal((bits[0] ^ bits[1] ^ bits[2]).numpy(),
                                  onehot)
    for b in bits:                     # every party's vector is dense
        assert 0.2 < b.float().mean() < 0.8


def test_k2_degenerates_to_the_two_server_scheme():
    """k = 2: the ring masks cancel pairwise (tests/test_protocols.py)."""
    cfg, ref_cfg = _cfgs(2, log_n=6)
    keys = protocol.get("xor-dpf-k").query_gen_batch(
        np.random.default_rng(3), [42], cfg)
    ref = ref_pir.batch_queries(np.random.default_rng(3), [42], ref_cfg)
    for r, p in zip(ref, keys):
        _assert_keys_equal(p, r)
    bits = [protocol._component_bits_batch(k, 0, 6) for k in keys]
    onehot = np.zeros((1, 64), np.int32)
    onehot[0, 42] = 1
    np.testing.assert_array_equal((bits[0] ^ bits[1]).numpy(), onehot)
    db = pir.make_database(np.random.default_rng(5), 64, 32)
    two = TwoServerPIR(db, cfg, device="cpu", n_queries=2,
                       client_rng=np.random.default_rng(6))
    np.testing.assert_array_equal(two.query([42, 0, 63]), db[[42, 0, 63]])


def test_k_rules_and_plans():
    cfg, ref_cfg = _cfgs(3)
    proto = protocol.get("xor-dpf-k")
    assert proto.n_parties(cfg) == 3 and cfg.share_kind == "xor"
    assert proto.record_struct(cfg) == \
        ref_protocol.get("xor-dpf-k").record_struct(ref_cfg)
    with pytest.raises(ValueError, match="n_servers >= 2"):
        proto.n_parties(_cfgs(1)[0])
    with pytest.raises(ValueError, match="out of domain"):
        proto.query_gen_batch(np.random.default_rng(0), [1 << LOG_N], cfg)
    for n_items, q in ((1 << 25, 1), (1 << 25, 32), (1 << 12, 8)):
        for backend in ("cuda", "cpu"):
            k_plan = protocol.plan_for(
                PIRConfig(n_items=n_items, protocol="xor-dpf-k",
                          n_servers=3), q, backend=backend)
            two = protocol.plan_for(PIRConfig(n_items=n_items), q,
                                    backend=backend)
            assert k_plan == two
        ref = heuristic_plan(RefPIRConfig(n_items=n_items,
                                          protocol="xor-dpf-k", n_servers=3),
                             q, backend="cpu")
        assert k_plan.expand == ref.expand


# ---------------------------------------------------------------------------
# Served end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k3_system():
    cfg = configs.PIR_SMOKE_K3
    db = pir.make_database(np.random.default_rng(0), cfg.n_items,
                           cfg.item_bytes)
    return db, MultiServerPIR(db, cfg, device="cpu", n_queries=4,
                              client_rng=np.random.default_rng(1))


@pytest.mark.parametrize("n", [1, 4, 6])
def test_multi_server_k3_returns_records(k3_system, n):
    db, system = k3_system
    assert system.n_parties == 3
    idx = list(np.random.default_rng(n).integers(0, len(db), size=n))
    got = system.query(idx)
    assert got.dtype == np.uint32 and got.shape == (n, 8)
    np.testing.assert_array_equal(got, db[idx])


def test_multi_server_k3_session_and_kernel_paths(k3_system):
    db, system = k3_system
    with system:
        futs = [system.submit(i) for i in (0, len(db) - 1, 99)]
        recs = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_array_equal(recs, db[[0, len(db) - 1, 99]])
    for path, kernel in (("cuda", "dpxor"), ("fused-cuda", "fused_scan_xor")):
        forced = MultiServerPIR(db, configs.PIR_SMOKE_K3, device="cpu",
                                n_queries=4, path=path,
                                client_rng=np.random.default_rng(2))
        ops.reset_counts()
        np.testing.assert_array_equal(forced.query([5, 6]), db[[5, 6]])
        assert ops.counts()[kernel]["plain_calls"] == 3      # one per party


def test_two_server_refuses_k3(k3_system):
    db, _ = k3_system
    with pytest.raises(ValueError, match="MultiServerPIR"):
        TwoServerPIR(db, configs.PIR_SMOKE_K3, device="cpu")


def test_component_keys_stack_and_pad(k3):
    """The scheduler's collate and padding keep the component axis."""
    _, _, _, port, _ = k3
    keys = port[0]
    again = dpf.stack_keys([dpf.key_at(keys, i) for i in range(len(IDXS))])
    for name in ("root_seed", "cw_seed", "cw_t"):
        assert torch.equal(getattr(again, name), getattr(keys, name))
    padded = protocol.get("xor-dpf-k").pad(keys, 5)
    assert padded.root_seed.shape == (5, 3, 4)
    assert torch.equal(padded.cw_seed[4], keys.cw_seed[-1])
