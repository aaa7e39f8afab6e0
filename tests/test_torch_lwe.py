"""Port parity: the single-server LWE scheme (``lwe-simple-1``), repro_torch
vs repro.

The same numpy inputs go through both packages: the parameter table, the
public matrix A (drawn whole and in row chunks), the client's ciphertexts
and secrets for a seeded rng, the int32 byte view, the wrapping int32 GEMM
(the reference's Pallas kernel in interpret mode, the port's plain
version), the hint, decoding, the protocol under every CPU plan, and the
served deployment (``SingleServerPIR``). All of it is integer arithmetic,
so every comparison is exact equality.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import PIRConfig as RefPIRConfig
from repro.core import lwe as ref_lwe
from repro.core import protocol as ref_protocol
from repro.crypto import packing as ref_packing
from repro.engine.tuner import heuristic_plan
from repro.kernels import ops as ref_ops
from repro_torch.config import PIRConfig
from repro_torch.configs import pir as configs
from repro_torch.core import lwe, pir, protocol
from repro_torch.core.server import BucketedServeFns
from repro_torch.crypto import packing
from repro_torch.db import Database, IntegrityError
from repro_torch.kernels import lwe_matmul as kl
from repro_torch.kernels import ops
from repro_torch.runtime.serve_loop import (MultiServerPIR, SingleServerPIR,
                                            TwoServerPIR)

RNG = np.random.default_rng(1317)


def _lwe_cfg(n_items, **kw):
    return PIRConfig(n_items=n_items, item_bytes=32, protocol="lwe-simple-1",
                     n_servers=1, **kw)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_param_table_matches_reference():
    assert len(lwe.PARAM_TABLE) == len(ref_lwe.PARAM_TABLE)
    for (m, p), (rm, rp) in zip(lwe.PARAM_TABLE, ref_lwe.PARAM_TABLE):
        assert m == rm
        assert dataclasses.asdict(p) == dataclasses.asdict(rp)
        assert (p.q, p.delta, p.noise_budget) == \
            (rp.q, rp.delta, rp.noise_budget)
        assert p.noise_bound(m) == rp.noise_bound(m)
        assert p.validate(m) is p
    assert (lwe.LWE_Q, lwe.LWE_P, lwe.TAIL) == \
        (ref_lwe.LWE_Q, ref_lwe.LWE_P, ref_lwe.TAIL)


@pytest.mark.parametrize("n_items", [1 << 10, 1 << 16, (1 << 16) + 1,
                                     1 << 20, 1 << 22, 1 << 25])
def test_params_for_matches_reference(n_items):
    got, want = lwe.params_for(n_items), ref_lwe.params_for(n_items)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kwargs,n_items,match", [
    ({"n": 128, "sigma": 1e6}, 1 << 16, "noise bound"),
    ({"n": 128, "sigma": 1.0, "p": 3}, 1 << 10, "must divide"),
    ({"n": 0, "sigma": 1.0}, 1 << 10, "degenerate"),
    ({"n": 128, "sigma": 0.0}, 1 << 10, "degenerate"),
])
def test_validate_raises_as_reference(kwargs, n_items, match):
    with pytest.raises(ValueError, match=match):
        ref_lwe.LWEParams(**kwargs).validate(n_items)
    with pytest.raises(ValueError, match=match):
        lwe.LWEParams(**kwargs).validate(n_items)


def test_params_for_raises_past_the_table():
    for mod in (lwe, ref_lwe):
        with pytest.raises(ValueError, match="extend PARAM_TABLE"):
            mod.params_for(1 << 26)


def test_port_config_keeps_the_1g_parameter_row():
    """PIR_128M_LWE cuts only N: it keeps the 1 GiB point's row."""
    assert lwe.params_for(configs.PIR_128M_LWE.n_items) is \
        lwe.PARAM_TABLE[2][1]
    assert lwe.params_for(configs.PIR_128M_LWE.n_items) == \
        lwe.params_for(1 << 25)


# ---------------------------------------------------------------------------
# Public matrix A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items", [1 << 8, 1 << 11])
def test_matrix_a_matches_reference(n_items):
    params = lwe.params_for(n_items)
    want = ref_lwe.matrix_a(ref_lwe.params_for(n_items), n_items)
    got = lwe.matrix_a(params, n_items)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_rows", [1, 3, 64, 1 << 14])
def test_matrix_a_device_in_row_chunks_matches_reference(monkeypatch,
                                                         chunk_rows):
    """Row chunks drawn from advanced generators, on several threads, give
    the reference's one-call A bit for bit."""
    n_items = 1 << 9
    params = lwe.params_for(n_items)
    lwe.clear_matrix_cache()
    monkeypatch.setattr(lwe, "A_CHUNK_ROWS", chunk_rows)
    got = lwe.matrix_a_device(params, n_items, "cpu")
    lwe.clear_matrix_cache()
    want = ref_lwe.matrix_a(ref_lwe.params_for(n_items), n_items)
    assert got.dtype == torch.int32 and got.shape == (n_items, params.n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.astype(np.uint32))


def test_matrix_a_rows_and_device_cache():
    params = lwe.params_for(1 << 8)
    whole = ref_lwe.matrix_a(ref_lwe.params_for(1 << 8), 1 << 8)
    np.testing.assert_array_equal(
        lwe.matrix_a_rows(params.a_seed, params.n, 10, 17), whole[10:17])
    with pytest.raises(ValueError, match="64-bit step"):
        lwe.matrix_a_rows(params.a_seed, 7, 1, 2)
    lwe.clear_matrix_cache()
    first = lwe.matrix_a_device(params, 1 << 8, "cpu")
    assert lwe.matrix_a_device(params, 1 << 8, "cpu") is first
    lwe.clear_matrix_cache()
    assert lwe.matrix_a_device(params, 1 << 8, "cpu") is not first


# ---------------------------------------------------------------------------
# Client: encryption and decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items,indices", [
    (1 << 8, [0]), (1 << 8, [3, 200, 255, 3]), (1 << 12, [4095, 17])])
def test_encrypt_batch_matches_reference_loop(n_items, indices):
    """One batched encryption draws the rng as the reference's per-query
    ``encrypt`` loop: the same ciphertexts and secrets, and the same rng
    state afterwards."""
    ref_rng, rng = np.random.default_rng(5), np.random.default_rng(5)
    ref_params = ref_lwe.params_for(n_items)
    want = [ref_lwe.encrypt(ref_rng, i, n_items, ref_params)
            for i in indices]
    ct, states = lwe.encrypt_batch(rng, indices, n_items,
                                   lwe.params_for(n_items), "cpu")
    assert ct.ct.dtype == torch.int32 and ct.ct.shape == (len(indices),
                                                          n_items)
    np.testing.assert_array_equal(
        ct.ct.numpy(), np.stack([np.asarray(c.ct) for c, _ in want]))
    assert (ct.log_n, ct.n) == (want[0][0].log_n, want[0][0].n)
    for st, (_, ref_st) in zip(states, want):
        assert st.s.dtype == np.uint64 and st.index == ref_st.index
        np.testing.assert_array_equal(st.s, ref_st.s)
    assert rng.integers(1 << 30) == ref_rng.integers(1 << 30)


def test_encrypt_rejects_out_of_range_index():
    params = lwe.params_for(1 << 8)
    for bad in (-1, 1 << 8):
        with pytest.raises(ValueError, match="out of range"):
            lwe.encrypt_batch(np.random.default_rng(0), [1, bad], 1 << 8,
                              params, "cpu")


def test_decode_matches_reference():
    n_items, q = 1 << 10, 3
    params = lwe.params_for(n_items)
    answers = RNG.integers(-(1 << 31), 1 << 31, size=(q, 32)).astype(np.int32)
    secrets = RNG.integers(0, 1 << 32, size=(q, params.n), dtype=np.uint64)
    hint = RNG.integers(0, 1 << 32, size=(params.n, 32), dtype=np.uint64)
    got = lwe.decode(answers, secrets, hint, params)
    want = ref_lwe.decode(answers, secrets, hint,
                          ref_lwe.params_for(n_items))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The int32 byte view
# ---------------------------------------------------------------------------

def test_words_to_bytes_i32_matches_reference():
    w = RNG.integers(0, 1 << 32, size=(5, 8), dtype=np.uint32)
    got = packing.words_to_bytes_i32(packing.words_to_tensor(w))
    want = np.asarray(ref_packing.words_to_bytes_i32(jnp.asarray(w)))
    assert got.dtype == torch.int32 and int(got.max()) > 127  # widened
    np.testing.assert_array_equal(got.numpy(), want)


def test_database_bytes32_view_is_built_once_and_counted():
    cfg = _lwe_cfg(1 << 6)
    words = pir.make_database(np.random.default_rng(3), cfg.n_items, 32)
    database = Database(words, cfg, "cpu")
    assert database.resident_bytes == words.nbytes       # not built yet
    view = database.view("bytes32")
    want = np.asarray(ref_packing.words_to_bytes_i32(jnp.asarray(words)))
    assert view.dtype == torch.int32 and view.shape == (cfg.n_items, 32)
    np.testing.assert_array_equal(view.numpy(), want)
    assert database.view("bytes32") is view
    assert database.snapshot(("bytes32",))[1]["bytes32"] is view
    assert database.resident_bytes == words.nbytes * 5
    assert database.spec.view_shape("bytes32") == (cfg.n_items, 32)


# ---------------------------------------------------------------------------
# The wrapping int32 GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,p", [(1, 256, 32), (4, 1024, 32), (3, 512, 8),
                                   (32, 256, 16), (36, 256, 32),
                                   (32, 256, 36), (33, 256, 40)])
def test_lwe_gemm_plain_matches_reference_kernel(m, k, p):
    """Full-range int32 operands, so every sum wraps past 2^32."""
    a = RNG.integers(-(1 << 31), 1 << 31, size=(m, k)).astype(np.int32)
    b = RNG.integers(-(1 << 31), 1 << 31, size=(k, p)).astype(np.int32)
    exact = a.astype(object) @ b.astype(object)
    assert max(abs(int(x)) for x in exact.ravel()) > (1 << 32)
    want = np.asarray(ref_ops.lwe_gemm(jnp.asarray(a), jnp.asarray(b),
                                       tile_q=1, tile_r=128, tile_l=8))
    oracle = ((a.view(np.uint32).astype(np.uint64)
               @ b.view(np.uint32).astype(np.uint64))
              & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(want, oracle)
    got = ops.lwe_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lwe_gemm_plain_blocks_match_one_pass(monkeypatch):
    a = torch.from_numpy(RNG.integers(-(1 << 31), 1 << 31, (9, 40))
                         .astype(np.int32))
    b = torch.from_numpy(RNG.integers(-(1 << 31), 1 << 31, (40, 6))
                         .astype(np.int32))
    whole = kl.lwe_gemm_plain(a, b)
    monkeypatch.setattr(kl, "_PLAIN_ELEMS", 2 * 6 * 7)     # 7-row K blocks
    assert torch.equal(kl.lwe_gemm_plain(a, b), whole)
    monkeypatch.setattr(kl, "_PLAIN_ELEMS", 5)             # row blocks too
    assert torch.equal(kl.lwe_gemm_plain(a, b), whole)


def test_lwe_gemm_checks_and_counts():
    a = torch.zeros((2, 8), dtype=torch.int32)
    ops.reset_counts()
    ops.lwe_gemm(a, torch.zeros((8, 3), dtype=torch.int32))
    assert ops.counts()["lwe_gemm"] == {"launches": 0, "plain_calls": 1}
    with pytest.raises(ValueError, match="mismatch"):
        ops.lwe_gemm(a, torch.zeros((7, 3), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        ops.lwe_gemm(a.to(torch.int64), torch.zeros((8, 3),
                                                    dtype=torch.int64))


# ---------------------------------------------------------------------------
# Server: the hint and the answer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items", [1 << 8, 1 << 10])
def test_hint_matches_reference(n_items):
    words = pir.make_database(np.random.default_rng(n_items), n_items, 32)
    ref_params = ref_lwe.params_for(n_items)
    db_u8 = ref_packing.np_words_to_bytes(words)
    want_np = ref_lwe.hint_np(ref_params, db_u8)
    want_dev = np.asarray(ref_lwe.hint_build_fn(ref_params, n_items)(
        jnp.asarray(words)))
    np.testing.assert_array_equal(want_dev.view(np.uint32),
                                  want_np.astype(np.uint32))
    lwe.clear_matrix_cache()
    got = lwe.hint_build_fn(lwe.params_for(n_items), n_items)(
        packing.words_to_tensor(words))
    assert got.dtype == torch.int32 and got.shape == (ref_params.n, 32)
    np.testing.assert_array_equal(got.numpy(), want_dev)
    np.testing.assert_array_equal(
        lwe.hint_np(lwe.params_for(n_items), db_u8), want_np)


#: port plan -> the reference plan it must agree with
PLAN_PAIRS = {("materialize", "torch"): ("materialize", "jnp"),
              ("materialize", "cuda"): ("materialize", "pallas")}
A_LOG_N = 8
A_IDXS = [3, 200, 255]


@pytest.fixture(scope="module")
def lwe_setup():
    n_items = 1 << A_LOG_N
    words = pir.make_database(np.random.default_rng(21), n_items, 32)
    db32 = np.array(ref_packing.words_to_bytes_i32(jnp.asarray(words)))
    ref_cfg = RefPIRConfig(n_items=n_items, protocol="lwe-simple-1",
                           n_servers=1)
    ref_proto = ref_protocol.get("lwe-simple-1")
    rng = np.random.default_rng(22)
    ref_q = [ref_proto.query_gen_full(rng, i, ref_cfg) for i in A_IDXS]
    ct = np.stack([np.asarray(k[0].ct) for k, _ in ref_q])
    states = [s for _, s in ref_q]
    return words, db32, ct, states


@pytest.mark.parametrize("expand,scan", sorted(PLAN_PAIRS))
def test_lwe_answer_local_matches_reference(lwe_setup, expand, scan):
    words, db32, ct, _ = lwe_setup
    ref_keys = ref_lwe.LWECiphertext(ct=jnp.asarray(ct), log_n=A_LOG_N,
                                     n=lwe.params_for(1 << A_LOG_N).n)
    want = np.asarray(ref_protocol.get("lwe-simple-1").answer_local(
        jnp.asarray(db32), ref_keys, 0, A_LOG_N,
        ref_protocol.ExecutionPlan(*PLAN_PAIRS[(expand, scan)])))
    keys = lwe.LWECiphertext(ct=_i32(ct), log_n=A_LOG_N, n=ref_keys.n)
    ops.reset_counts()
    got = protocol.get("lwe-simple-1").answer_local(
        torch.from_numpy(db32), keys, 0, A_LOG_N,
        protocol.ExecutionPlan(expand, scan))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.counts()["lwe_gemm"]["plain_calls"] == int(scan == "cuda")


def test_reconstruct_with_decodes_and_rejects_a_wrong_hint(lwe_setup):
    words, db32, ct, states = lwe_setup
    cfg = _lwe_cfg(1 << A_LOG_N)
    proto = protocol.get("lwe-simple-1")
    ans = kl.lwe_gemm_plain(_i32(ct), torch.from_numpy(db32))
    hint = lwe.hint_build_fn(lwe.params_for(cfg.n_items), cfg.n_items)(
        packing.words_to_tensor(words)).numpy()
    rec = proto.reconstruct_with([ans], states, cfg=cfg, hint=hint)
    assert rec.dtype == np.uint8
    np.testing.assert_array_equal(rec, db32[A_IDXS].astype(np.uint8))
    want = np.asarray(ref_protocol.get("lwe-simple-1").reconstruct_with(
        [jnp.asarray(ans.numpy())], states,
        cfg=RefPIRConfig(**cfg.to_dict()), hint=jnp.asarray(hint)))
    np.testing.assert_array_equal(rec, want)
    # the hint of another epoch's data: the noise check trips
    other = pir.make_database(np.random.default_rng(99), cfg.n_items, 32)
    stale = lwe.hint_build_fn(lwe.params_for(cfg.n_items), cfg.n_items)(
        packing.words_to_tensor(other)).numpy()
    with pytest.raises(IntegrityError, match="noise overflow"):
        proto.reconstruct_with([ans], states, cfg=cfg, hint=stale)
    with pytest.raises(ValueError, match="needs cfg"):
        proto.reconstruct_with([ans], states, cfg=cfg)
    with pytest.raises(NotImplementedError):
        proto.reconstruct([ans])


def test_pad_repeats_the_last_ciphertext():
    proto = protocol.get("lwe-simple-1")
    keys = lwe.LWECiphertext(ct=torch.arange(12, dtype=torch.int32)
                             .reshape(3, 4), log_n=2, n=128)
    padded = proto.pad(keys, 5)
    assert proto.n_queries(padded) == 5
    assert torch.equal(padded.ct[:3], keys.ct)
    assert torch.equal(padded.ct[3], keys.ct[2])
    assert torch.equal(padded.ct[4], keys.ct[2])
    assert proto.pad(keys, 3) is keys
    with pytest.raises(ValueError, match="cannot pad"):
        proto.pad(keys, 2)


def test_lwe_protocol_metadata_matches_reference():
    cfg = configs.PIR_SMOKE_LWE
    ref_cfg = RefPIRConfig(**cfg.to_dict())
    proto, ref_proto = protocol.for_config(cfg), ref_protocol.for_config(
        ref_cfg)
    for attr in ("name", "share_kind", "db_view", "needs_hint"):
        assert getattr(proto, attr) == getattr(ref_proto, attr)
    assert proto.n_parties(cfg) == ref_proto.n_parties(ref_cfg) == 1
    assert proto.record_struct(cfg) == ref_proto.record_struct(ref_cfg)
    assert cfg.share_kind == "lwe"


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("bucket", [1, 2, 4, 8, 16, 32])
def test_plan_for_lwe_materializes_at_every_bucket(backend, bucket):
    cfg = configs.PIR_128M_LWE
    want = heuristic_plan(RefPIRConfig(**cfg.to_dict()), bucket,
                          backend="cpu")
    got = protocol.plan_for(cfg, bucket, backend=backend)
    assert got.expand == want.expand == "materialize"
    assert got.scan == ("cuda" if backend == "cuda" else "torch")
    assert got.tile_r == want.tile_r == protocol.GEMM_TILE_R_DEFAULT
    forced = protocol.resolve_plan("cuda", cfg, bucket, backend=backend)
    assert forced.tile_r == protocol.GEMM_TILE_R_DEFAULT


def test_stage_keeps_keys_in_place_on_the_host():
    fns = BucketedServeFns(_lwe_cfg(1 << 4), buckets=(4,), backend="cpu")
    keys = lwe.LWECiphertext(ct=torch.zeros((2, 16), dtype=torch.int32),
                             log_n=4, n=128)
    staged = fns.stage(keys, torch.device("cpu"))
    assert staged.ct.data_ptr() == keys.ct.data_ptr()


# ---------------------------------------------------------------------------
# Database hints and the deployment
# ---------------------------------------------------------------------------

def test_database_hint_registry():
    cfg = _lwe_cfg(1 << 8)
    words = pir.make_database(np.random.default_rng(4), cfg.n_items, 32)
    database = Database(words, cfg, "cpu")
    with pytest.raises(KeyError, match="unknown hint"):
        database.hint("lwe-simple-1")
    proto = protocol.for_config(cfg)
    database.register_hint(proto.name, proto.hint_builder(cfg))
    hint = database.hint(proto.name)
    assert database.hint(proto.name, epoch=0) is hint
    assert database.n_hint_builds == 1
    with pytest.raises(KeyError, match="not resident"):
        database.hint(proto.name, epoch=1)
    np.testing.assert_array_equal(
        hint.numpy().view(np.uint32),
        ref_lwe.hint_np(ref_lwe.params_for(cfg.n_items),
                        ref_packing.np_words_to_bytes(words))
        .astype(np.uint32))


def test_multi_and_two_server_refuse_lwe_and_single_refuses_k_party():
    db = pir.make_database(np.random.default_rng(0), 1 << 8, 32)
    with pytest.raises(ValueError, match="SingleServerPIR"):
        MultiServerPIR(db, _lwe_cfg(1 << 8), device="cpu")
    with pytest.raises(ValueError, match="2-party"):
        TwoServerPIR(db, _lwe_cfg(1 << 8), device="cpu")
    with pytest.raises(ValueError, match="1-party"):
        SingleServerPIR(db, PIRConfig(n_items=1 << 8), device="cpu")


@pytest.fixture(scope="module")
def ref_and_port_systems():
    """The reference's and the port's SingleServerPIR over the same DB,
    with client rngs of the same seed (the reference's own session test
    scale, 2^10 rows)."""
    from repro.launch.mesh import make_local_mesh
    from repro.runtime.serve_loop import SingleServerPIR as RefSingle
    cfg = _lwe_cfg(1 << 10, batch_queries=2)
    words = pir.make_database(np.random.default_rng(9), cfg.n_items, 32)
    ref = RefSingle(words, RefPIRConfig(**cfg.to_dict()), make_local_mesh(),
                    client_rng=np.random.default_rng(10))
    port = SingleServerPIR(words, cfg, device="cpu",
                           client_rng=np.random.default_rng(10))
    return words, ref, port


def test_single_server_query_matches_reference(ref_and_port_systems):
    words, ref, port = ref_and_port_systems
    db_u8 = ref_packing.np_words_to_bytes(words)
    for idx in ([3, 777], [511], [0, 1023, 5, 6, 7]):
        got = port.query(idx)
        assert got.dtype == np.uint8 and got.shape == (len(idx), 32)
        np.testing.assert_array_equal(got, db_u8[idx])
        np.testing.assert_array_equal(got, np.asarray(ref.query(idx)))
    assert port.hint_fetches == ref.hint_fetches == 1
    assert port.db.n_hint_builds == 1
    assert port.query([]).shape == (0, 32)


def test_single_server_session_and_client_rng_parity(ref_and_port_systems):
    """A session answers with epoch tags, and after the same queries both
    client rngs stand at the same state (same draws, same order)."""
    words, ref, port = ref_and_port_systems
    db_u8 = ref_packing.np_words_to_bytes(words)
    with port:
        futs = [port.submit(i) for i in (42, 1000, 8)]
        recs = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_array_equal(recs, db_u8[[42, 1000, 8]])
    assert all(f.epoch == 0 for f in futs)
    np.testing.assert_array_equal(np.asarray(ref.query([42, 1000, 8])),
                                  recs)
    assert port.rng.integers(1 << 30) == ref.rng.integers(1 << 30)
    assert port.hint_fetches == 1


@pytest.mark.parametrize("n", [1, 3, 4, 9])
def test_single_server_smoke_scale_records(n):
    """PIR_SMOKE_LWE (2^14 rows) on the CPU: ragged batches pad to a
    bucket, batches past the largest bucket are chunked, one hint fetch."""
    cfg = configs.PIR_SMOKE_LWE
    words = pir.make_database(np.random.default_rng(0), cfg.n_items, 32)
    system = SingleServerPIR(words, cfg, device="cpu", n_queries=4,
                             client_rng=np.random.default_rng(n))
    idx = list(np.random.default_rng(n + 1).integers(0, cfg.n_items, size=n))
    ops.reset_counts()
    got = system.query(idx)
    np.testing.assert_array_equal(got, packing.np_words_to_bytes(words[idx]))
    assert system.hint_fetches == 1
    assert {b: r["plan"] for b, r in
            system.servers[0].plan_report().items()} == {
        1: "materialize/torch", 2: "materialize/torch",
        4: "materialize/torch"}
    assert ops.counts()["lwe_gemm"]["launches"] == 0
    assert ops.counts()["lwe_gemm"]["plain_calls"] >= 2   # A.S, answer
