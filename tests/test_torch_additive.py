"""Port parity: the additive scheme (``additive-dpf-2``), repro_torch vs repro.

The same numpy inputs go through both packages: the int8 GEMM and the
fused expand + select-add (the reference's Pallas kernels in interpret
mode, the port's plain versions), payload keys and Z_256 shares, the byte
view of the database, the protocol under every CPU plan, and the served
deployment. Integer-exact: every comparison is array equality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import PIRConfig as RefPIRConfig
from repro.core import dpf as ref_dpf
from repro.core import pir as ref_pir
from repro.core import protocol as ref_protocol
from repro.crypto import packing as ref_packing
from repro.engine.tuner import heuristic_plan
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.config import PIRConfig
from repro_torch.configs import pir as configs
from repro_torch.core import dpf, pir, protocol
from repro_torch.crypto import packing
from repro_torch.db import Database
from repro_torch.kernels import fused_scan as kf
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pir_matmul as km
from repro_torch.runtime.serve_loop import TwoServerPIR

RNG = np.random.default_rng(13)
PAYLOAD = np.array([1], np.uint32)


def _u(t):
    return t.numpy().view(np.uint32)


def _port_keys(k):
    """A reference (batched) key as the port's, cw_final included."""
    return convert.keys_from_reference(
        party=k.party, log_n=k.log_n, root_seed=np.asarray(k.root_seed),
        cw_seed=np.asarray(k.cw_seed), cw_t=np.asarray(k.cw_t),
        cw_final=None if k.cw_final is None else np.asarray(k.cw_final),
        rounds=k.rounds)


def _ref_add_keys(rng, idxs, log_n):
    pairs = [ref_dpf.gen_keys(rng, i, log_n, payload=PAYLOAD,
                              payload_mod=256) for i in idxs]
    return [ref_dpf.stack_keys([p[b] for p in pairs]) for b in (0, 1)]


# ---------------------------------------------------------------------------
# int8 GEMM (tests/test_kernels.py's pir_matmul cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,r,l", [(1, 64, 8), (4, 256, 32), (3, 128, 16)])
def test_pir_gemm_plain_matches_reference(q, r, l):
    s = RNG.integers(-128, 128, size=(q, r)).astype(np.int8)
    d = RNG.integers(-128, 128, size=(r, l)).astype(np.int8)
    want_kernel = np.asarray(ref_ops.pir_gemm(jnp.asarray(s), jnp.asarray(d),
                                              tile_q=1, tile_r=64, tile_l=8))
    want_ref = np.asarray(ref_pir.answer_additive_matmul(jnp.asarray(d),
                                                         jnp.asarray(s)))
    got = ops.pir_gemm(convert.bytes_from_reference(s),
                       convert.bytes_from_reference(d)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


def test_pir_gemm_plain_wraps_like_int32():
    """A sum past 2^31 wraps exactly as XLA's int32 dot does."""
    r = 1 << 18
    s = np.full((2, r), -128, np.int8)
    s[1, ::3] = 127
    d = RNG.integers(-128, -100, size=(r, 4)).astype(np.int8)
    exact = s.astype(np.int64) @ d.astype(np.int64)
    assert np.abs(exact).max() > (1 << 31)
    want = np.asarray(ref_pir.answer_additive_matmul(jnp.asarray(d),
                                                     jnp.asarray(s)))
    got = km.pir_gemm_plain(torch.from_numpy(s), torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), km.wrap_int32(torch.from_numpy(exact)).numpy())


def test_pir_gemm_plain_row_blocks_match_one_pass(monkeypatch):
    s = torch.from_numpy(RNG.integers(-128, 128, (3, 100)).astype(np.int8))
    d = torch.from_numpy(RNG.integers(-128, 128, (100, 8)).astype(np.int8))
    whole = km.pir_gemm_plain(s, d)
    monkeypatch.setattr(km, "_PLAIN_ELEMS", 7 * 3 * 8)    # 7-row blocks
    assert torch.equal(km.pir_gemm_plain(s, d), whole)


def test_pir_gemm_mod256_semantics():
    """Complementary Z_256 shares reconstruct rows (as test_kernels.py)."""
    q, r, l = 2, 512, 16
    s0 = RNG.integers(0, 256, size=(q, r)).astype(np.uint8)
    onehot = np.zeros((q, r), np.uint8)
    onehot[0, 3] = 1
    onehot[1, 100] = 1
    s1 = (onehot - s0).astype(np.uint8)
    d = RNG.integers(0, 256, size=(r, l)).astype(np.uint8)
    db = torch.from_numpy(d.view(np.int8))
    r0 = ops.pir_gemm(torch.from_numpy(s0), db)
    r1 = ops.pir_gemm(torch.from_numpy(s1), db)
    rec = pir.reconstruct_additive(r0, r1).numpy()
    np.testing.assert_array_equal(rec[0], d[3])
    np.testing.assert_array_equal(rec[1], d[100])
    want = np.asarray(ref_pir.reconstruct_additive(jnp.asarray(r0.numpy()),
                                                   jnp.asarray(r1.numpy())))
    np.testing.assert_array_equal(rec, want)


def test_uint8_shares_are_reinterpreted_not_converted():
    s = torch.tensor([[200, 3]], dtype=torch.uint8)
    d = torch.tensor([[1], [1]], dtype=torch.int8)
    assert km.as_int8(s).dtype == torch.int8
    assert km.as_int8(s).data_ptr() == s.data_ptr()
    assert ops.pir_gemm(s, d).tolist() == [[200 - 256 + 3]]
    with pytest.raises(TypeError):
        km.as_int8(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="mismatch"):
        km.pir_gemm_plain(s, d[:1])


# ---------------------------------------------------------------------------
# Fused expand + select-add (tests/test_fused_scan.py's additive cases)
# ---------------------------------------------------------------------------

LOG_N = 5
N = 1 << LOG_N
L = 8
IDXS = [0, 13, 31]


@pytest.fixture(scope="module")
def add_setup():
    rng = np.random.default_rng(29)
    db = rng.integers(-128, 128, size=(N, L)).astype(np.int8)
    ref_keys = _ref_add_keys(rng, IDXS, LOG_N)
    return db, ref_keys, [_port_keys(k) for k in ref_keys]


def _fused_inputs(keys, clog, start_block, log_local, eval_roots):
    roots, t_roots = eval_roots(keys, start_block, log_local, clog)
    lvl0 = keys.log_n - clog
    return (roots, t_roots, keys.cw_seed[:, lvl0:, :],
            keys.cw_t[:, lvl0:, :], keys.cw_final[:, 0])


def _port_fused_add(db, keys, clog, start_block=0, log_local=LOG_N):
    return ops.fused_scan_bytes(
        convert.bytes_from_reference(db),
        *_fused_inputs(keys, clog, start_block, log_local,
                       dpf.eval_roots_batch), party=keys.party).numpy()


def _ref_fused_add(db, keys, tile_r, clog, start_block=0, log_local=LOG_N):
    return np.asarray(ref_ops.fused_scan_bytes(
        jnp.asarray(db),
        *_fused_inputs(keys, clog, start_block, log_local,
                       ref_dpf.eval_roots_batch),
        party=int(keys.party), tile_r=tile_r, depth=2))


@pytest.mark.parametrize("party,tile_r,clog", [
    (0, 8, 2), (1, 16, 3), (0, 32, 0), (1, 32, 0)])
def test_fused_add_plain_matches_reference_kernel(add_setup, party, tile_r,
                                                  clog):
    db, ref_keys, port_keys = add_setup
    want = _ref_fused_add(db, ref_keys[party], tile_r, clog)
    got = _port_fused_add(db, port_keys[party], clog)
    np.testing.assert_array_equal(got, want)
    shares = ref_dpf.eval_bytes_batch(ref_keys[party], 0, LOG_N)
    oracle = np.asarray(ref_pir.answer_additive_matmul(jnp.asarray(db),
                                                       shares))
    np.testing.assert_array_equal(got, oracle)


def test_fused_add_plain_start_block_matches_reference(add_setup):
    """Shard-local evaluation: start_block offsets the GGM descent."""
    db, ref_keys, port_keys = add_setup
    log_local = LOG_N - 2
    rows = 1 << log_local
    for blk in (1, 3):
        shard = db[blk * rows:(blk + 1) * rows]
        want = _ref_fused_add(shard, ref_keys[1], 4, 2, blk, log_local)
        got = _port_fused_add(shard, port_keys[1], 2, blk, log_local)
        np.testing.assert_array_equal(got, want, err_msg=f"shard {blk}")


def test_fused_add_parties_reconstruct_rows(add_setup):
    db, _, port_keys = add_setup
    a0, a1 = (torch.from_numpy(_port_fused_add(db, k, 3)) for k in port_keys)
    rec = pir.reconstruct_additive(a0, a1).numpy()
    np.testing.assert_array_equal(rec, db.view(np.uint8)[IDXS])


def test_fused_add_plain_chunk_blocks_match_one_pass(add_setup, monkeypatch):
    db, _, port_keys = add_setup
    whole = _port_fused_add(db, port_keys[0], 2)
    monkeypatch.setattr(kf, "_PLAIN_LEAVES", 3 * 4 * 3)   # 3-chunk blocks
    np.testing.assert_array_equal(_port_fused_add(db, port_keys[0], 2), whole)


def test_fused_add_plain_rejects_bad_arguments(add_setup):
    db, _, port_keys = add_setup
    inputs = _fused_inputs(port_keys[0], 3, 0, LOG_N, dpf.eval_roots_batch)
    dbt = convert.bytes_from_reference(db)
    with pytest.raises(ValueError, match="chunk roots"):
        kf.fused_scan_add_plain(dbt[:16], *inputs, party=0)
    with pytest.raises(ValueError, match="party"):
        kf.fused_scan_add_plain(dbt, *inputs, party=2)


def test_ref_module_names_the_additive_plain_versions():
    assert ref.pir_matmul_ref is km.pir_gemm_plain
    assert ref.fused_scan_add_ref is kf.fused_scan_add_plain


def test_additive_ops_refuse_cpu_tensors():
    s = torch.zeros((1, 8), dtype=torch.int8)
    d = torch.zeros((8, 8), dtype=torch.int8)
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.ops.repro_torch.pir_gemm(s, d)
    with pytest.raises((NotImplementedError, RuntimeError)):
        z = torch.zeros((1, 1, 4), dtype=torch.int32)
        torch.ops.repro_torch.fused_scan_add(
            d, z, torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 3, 4), dtype=torch.int32),
            torch.zeros((1, 3, 2), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32), 0, 12)


def test_additive_wrappers_count_plain_calls_on_cpu(add_setup):
    db, _, port_keys = add_setup
    ops.reset_counts()
    _port_fused_add(db, port_keys[0], 2)
    ops.pir_gemm(torch.zeros((1, 8), dtype=torch.int8),
                 torch.zeros((8, 4), dtype=torch.int8))
    assert ops.counts()["fused_scan_add"] == {"launches": 0,
                                              "plain_calls": 1}
    assert ops.counts()["pir_gemm"] == {"launches": 0, "plain_calls": 1}


# ---------------------------------------------------------------------------
# Payload keys and Z_256 shares
# ---------------------------------------------------------------------------

KEY_LOG_N = 7
KEY_ALPHAS = [0, 5, 77, 127]


@pytest.fixture(scope="module")
def payload_keys():
    ref = _ref_add_keys(np.random.default_rng(41), KEY_ALPHAS, KEY_LOG_N)
    port = dpf.gen_keys_batch(np.random.default_rng(41), KEY_ALPHAS,
                              KEY_LOG_N, payload=[1])
    return ref, port


@pytest.mark.parametrize("party", [0, 1])
def test_payload_keys_batch_field_by_field(payload_keys, party):
    ref, port = payload_keys
    r, k = ref[party], port[party]
    assert (k.party, k.log_n, k.rounds) == (r.party, r.log_n, r.rounds)
    for name in ("root_seed", "cw_seed", "cw_t", "cw_final"):
        np.testing.assert_array_equal(_u(getattr(k, name)),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)


def test_payload_draws_nothing_more_from_rng():
    """cw_final comes from the final seeds: the same generator yields the
    same keys with and without a payload, and ends in the same state."""
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    plain = dpf.gen_keys_batch(a, [3, 9], 6)
    paid = dpf.gen_keys_batch(b, [3, 9], 6, payload=[1])
    for name in ("root_seed", "cw_seed", "cw_t"):
        assert torch.equal(getattr(plain[0], name), getattr(paid[0], name))
    assert a.integers(1 << 30) == b.integers(1 << 30)
    assert plain[0].cw_final is None


@pytest.mark.parametrize("log_n,alpha", [(1, 1), (6, 40)])
def test_payload_keys_single_match_reference(log_n, alpha):
    beta = np.array([7, 0xFFFFFFFF], np.uint32)
    r0, r1 = ref_dpf.gen_keys(np.random.default_rng(log_n), alpha, log_n,
                              payload=beta)
    k0, k1 = dpf.gen_keys(np.random.default_rng(log_n), alpha, log_n,
                          payload=beta)
    for r, k in ((r0, k0), (r1, k1)):
        assert k.cw_final.shape == (2,)
        np.testing.assert_array_equal(_u(k.cw_final), np.asarray(r.cw_final))


@pytest.mark.parametrize("start_block,log_range", [(0, KEY_LOG_N), (3, 5),
                                                   (1, 3)])
def test_eval_bytes_batch_matches_reference(payload_keys, start_block,
                                            log_range):
    ref, port = payload_keys
    for p in (0, 1):
        want = np.asarray(ref_dpf.eval_bytes_batch(ref[p], start_block,
                                                   log_range))
        got = dpf.eval_bytes_batch(port[p], start_block, log_range)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_shares_sum_to_the_point_function(payload_keys):
    _, (k0, k1) = payload_keys
    total = (dpf.eval_bytes_batch(k0, 0, KEY_LOG_N).int()
             + dpf.eval_bytes_batch(k1, 0, KEY_LOG_N).int()) % 256
    want = np.zeros((len(KEY_ALPHAS), 1 << KEY_LOG_N), np.int32)
    want[np.arange(len(KEY_ALPHAS)), KEY_ALPHAS] = 1
    np.testing.assert_array_equal(total.numpy(), want)


def test_leaf_bytes_needs_a_payload():
    k0, _ = dpf.gen_keys_batch(np.random.default_rng(0), [1], 3)
    with pytest.raises(ValueError, match="payload"):
        dpf.eval_bytes_batch(k0, 0, 3)


# ---------------------------------------------------------------------------
# Byte view and packing
# ---------------------------------------------------------------------------

def test_database_bytes_view_matches_reference():
    cfg = PIRConfig(n_items=1 << 6, protocol="additive-dpf-2")
    words = pir.make_database(np.random.default_rng(3), cfg.n_items, 32)
    database = Database(words, cfg, "cpu")
    view = database.view("bytes")
    want = np.asarray(ref_packing.words_to_bytes_i8(jnp.asarray(words)))
    assert view.dtype == torch.int8 and view.shape == (cfg.n_items, 32)
    np.testing.assert_array_equal(view.numpy(), want)
    assert view.data_ptr() == database.view("words").data_ptr()  # an alias
    assert database.resident_bytes == words.nbytes
    assert database.spec.view_shape("bytes") == (cfg.n_items, 32)
    with pytest.raises(KeyError):
        database.view("nonsense")
    with pytest.raises(KeyError):
        database.spec.view_shape("bytes64")


def test_packing_matches_reference():
    w = RNG.integers(0, 1 << 32, size=(5, 8), dtype=np.uint32)
    t = packing.words_to_tensor(w)
    np.testing.assert_array_equal(
        packing.words_to_bytes(t).numpy(),
        np.asarray(ref_packing.words_to_bytes(jnp.asarray(w))))
    np.testing.assert_array_equal(
        packing.words_to_bytes_i8(t).numpy(),
        np.asarray(ref_packing.words_to_bytes_i8(jnp.asarray(w))))
    b = ref_packing.np_words_to_bytes(w)
    np.testing.assert_array_equal(packing.np_bytes_to_words(b),
                                  ref_packing.np_bytes_to_words(b))
    np.testing.assert_array_equal(pir.db_as_bytes(w), ref_pir.db_as_bytes(w))
    with pytest.raises(ValueError):
        packing.np_bytes_to_words(b[:, :3])


# ---------------------------------------------------------------------------
# The protocol under every plan
# ---------------------------------------------------------------------------

P_LOG_N = 8
P_IDXS = [3, 200, 255]
CHUNK_LOG = 4
TILE_R = 16

#: port plan -> the reference plan it must agree with
PLAN_PAIRS = {
    ("materialize", "torch"): ("materialize", "jnp"),
    ("materialize", "cuda"): ("materialize", "pallas"),
    ("fused", "torch"): ("fused", "jnp"),
    ("fused-cuda", "cuda"): ("fused-pallas", "pallas"),
}


@pytest.fixture(scope="module")
def proto_setup():
    rng = np.random.default_rng(17)
    words = rng.integers(0, 1 << 32, size=(1 << P_LOG_N, 8), dtype=np.uint32)
    db_i8 = ref_packing.np_words_to_bytes(words).view(np.int8)
    ref_keys = _ref_add_keys(rng, P_IDXS, P_LOG_N)
    return words, db_i8, ref_keys, [_port_keys(k) for k in ref_keys]


@pytest.mark.parametrize("expand,scan", sorted(PLAN_PAIRS))
def test_additive_answer_local_matches_reference(proto_setup, expand, scan):
    words, db_i8, ref_keys, port_keys = proto_setup
    ref_plan = ref_protocol.ExecutionPlan(
        *PLAN_PAIRS[(expand, scan)], chunk_log=CHUNK_LOG, tile_r=TILE_R)
    plan = protocol.ExecutionPlan(expand, scan, chunk_log=CHUNK_LOG,
                                  tile_r=TILE_R)
    ref_proto = ref_protocol.get("additive-dpf-2")
    proto = protocol.get("additive-dpf-2")
    db = convert.bytes_from_reference(db_i8)
    got, want = [], []
    for rk, pk in zip(ref_keys, port_keys):
        want.append(np.asarray(ref_proto.answer_local(
            jnp.asarray(db_i8), rk, 0, P_LOG_N, ref_plan)))
        got.append(proto.answer_local(db, pk, 0, P_LOG_N, plan))
        np.testing.assert_array_equal(got[-1].numpy(), want[-1])
    rec = proto.reconstruct(got)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(ref_proto.reconstruct(
            [jnp.asarray(w) for w in want])))
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(ref_pir.reconstruct_additive(*want)))
    np.testing.assert_array_equal(rec.numpy(),
                                  db_i8.view(np.uint8)[P_IDXS])


def test_additive_cuda_plans_route_through_the_kernel_wrappers(proto_setup):
    _, db_i8, _, port_keys = proto_setup
    proto = protocol.get("additive-dpf-2")
    ops.reset_counts()
    for expand in ("materialize", "fused-cuda"):
        proto.answer_local(convert.bytes_from_reference(db_i8), port_keys[0],
                           0, P_LOG_N, protocol.ExecutionPlan(expand, "cuda"))
    assert ops.counts() == {
        "dpxor": {"launches": 0, "plain_calls": 0},
        "fused_scan_xor": {"launches": 0, "plain_calls": 0},
        "pir_gemm": {"launches": 0, "plain_calls": 1},
        "fused_scan_add": {"launches": 0, "plain_calls": 1},
        "lwe_gemm": {"launches": 0, "plain_calls": 0},
        "ggm_expand": {"launches": 0, "plain_calls": 0}}


def test_additive_record_struct_and_registry():
    cfg = configs.PIR_SMOKE_ADD
    ref_cfg = RefPIRConfig(**cfg.to_dict())
    proto = protocol.for_config(cfg)
    assert proto.name == "additive-dpf-2" and proto.db_view == "bytes"
    assert cfg.share_kind == ref_cfg.share_kind == "additive"
    assert proto.record_struct(cfg) == \
        ref_protocol.for_config(ref_cfg).record_struct(ref_cfg)
    assert protocol.get("xor-dpf-2").record_struct(cfg) == ((8,), np.uint32)


@pytest.mark.parametrize("n_items,n_queries,want", [
    (1 << 25, 1, "materialize/cuda"),
    (1 << 25, 2, "fused-cuda/cuda"),
    (1 << 25, 32, "fused-cuda/cuda"),
    (1 << 12, 32, "materialize/cuda"),
])
def test_additive_plan_for_cuda_rules(n_items, n_queries, want):
    cfg = PIRConfig(n_items=n_items, protocol="additive-dpf-2")
    plan = protocol.plan_for(cfg, n_queries, backend="cuda")
    assert plan.name == want and plan.tile_r == protocol.GEMM_TILE_R_DEFAULT
    # the pinned GEMM tile legalizes chunk_log to 10 at 2^25 rows
    assert ops.fused_tile(n_items, plan.tile_r, plan.chunk_log)[1] == \
        min(10, n_items.bit_length() - 1)


@pytest.mark.parametrize("n_items,n_queries", [(1 << 25, 1), (1 << 25, 32),
                                               (1 << 12, 4)])
def test_additive_plan_for_cpu_follows_reference_heuristic(n_items,
                                                           n_queries):
    want = heuristic_plan(RefPIRConfig(n_items=n_items,
                                       protocol="additive-dpf-2"),
                          n_queries, backend="cpu")
    got = protocol.plan_for(PIRConfig(n_items=n_items,
                                      protocol="additive-dpf-2"),
                            n_queries, backend="cpu")
    assert (got.expand, got.scan, got.tile_r) == \
        (want.expand, "torch", want.tile_r)


def test_additive_forced_plans_pin_the_gemm_tile():
    cfg = configs.PIR_1G_ADD
    for path, ref_path in (("baseline", "baseline"), ("cuda", "pallas"),
                           ("fused-cuda", "fused-pallas")):
        plan = protocol.resolve_plan(path, cfg, 8, backend="cuda")
        want = ref_protocol.resolve_plan(ref_path,
                                         RefPIRConfig(**cfg.to_dict()), 8)
        assert plan.tile_r == want.tile_r == protocol.GEMM_TILE_R_DEFAULT
        assert plan.provenance == "forced"


# ---------------------------------------------------------------------------
# Served end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def add_system():
    cfg = configs.PIR_SMOKE_ADD
    db = pir.make_database(np.random.default_rng(0), cfg.n_items,
                           cfg.item_bytes)
    return db, TwoServerPIR(db, cfg, device="cpu", n_queries=4,
                            client_rng=np.random.default_rng(1))


@pytest.mark.parametrize("n", [1, 3, 4, 9])
def test_two_server_additive_returns_byte_records(add_system, n):
    db, system = add_system
    idx = list(np.random.default_rng(n).integers(0, len(db), size=n))
    got = system.query(idx)
    assert got.dtype == np.uint8 and got.shape == (n, 32)
    np.testing.assert_array_equal(got, pir.db_as_bytes(db[idx]))


def test_two_server_additive_edges_and_session(add_system):
    db, system = add_system
    empty = system.query([])
    assert empty.dtype == np.uint8 and empty.shape == (0, 32)
    assert {b: r["plan"] for b, r in
            system.servers[0].plan_report().items()} == {
        1: "materialize/torch", 2: "materialize/torch",
        4: "materialize/torch"}
    with system:
        futs = [system.submit(i) for i in (5, len(db) - 1, 77)]
        recs = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_array_equal(recs,
                                  pir.db_as_bytes(db[[5, len(db) - 1, 77]]))


def test_two_server_additive_on_the_kernel_paths(add_system):
    """The CUDA plans, forced on the CPU, take the plain versions and
    return the same records."""
    db, _ = add_system
    cfg = configs.PIR_SMOKE_ADD
    for path, kernel in (("cuda", "pir_gemm"), ("fused-cuda",
                                                "fused_scan_add")):
        system = TwoServerPIR(db, cfg, device="cpu", n_queries=4, path=path,
                              client_rng=np.random.default_rng(2))
        ops.reset_counts()
        np.testing.assert_array_equal(system.query([9, 10, 11]),
                                      pir.db_as_bytes(db[[9, 10, 11]]))
        assert ops.counts()[kernel]["plain_calls"] == 2
