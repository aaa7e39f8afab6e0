"""Port parity: the batch plane (repro_torch vs repro).

The port's numpy copy of the cuckoo layer (``core/batch.py``) against the
reference's: parameters, bucket hashes, the layout field by field (the
port builds it without the reference's per-bucket regather), the cuckoo
walk and ``plan_round`` under one seed, keys included. Then the port's
``BucketedDatabase`` against the reference's (per-bucket views, the
stage/publish fan-out) and ``BatchPIR`` against the reference's oracle
records for the three k-party schemes with checksums on. Everything is
integer or seeded, so every comparison is exact equality.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import PIRConfig as RefPIRConfig
from repro.core import batch as ref_batch
from repro.core.protocol import for_config as ref_for_config
from repro.db import BucketedDatabase as RefBucketedDatabase
from repro.launch.mesh import make_local_mesh
from repro_torch import batch_query
from repro_torch.config import PIRConfig
from repro_torch.core import batch, pir, protocol
from repro_torch.crypto import packing
from repro_torch.db import BucketedDatabase, DatabaseSpec
from repro_torch.runtime import batch as runtime_batch
from repro_torch.runtime.batch import BatchPIR

N = 1 << 8
DB = pir.make_database(np.random.default_rng(5), N, 32)
BATCH_PROTOCOLS = [("xor-dpf-2", 2), ("additive-dpf-2", 2), ("xor-dpf-k", 3)]


def _ref_cfg(cfg: PIRConfig) -> RefPIRConfig:
    return RefPIRConfig(**cfg.to_dict())


def _batch_cfg(name="xor-dpf-2", n_servers=2, **kw) -> PIRConfig:
    return PIRConfig(n_items=N, protocol=name, n_servers=n_servers,
                     batch_m=4, checksum=True, **kw)


def _oracle(cfg, words, idx):
    rows = words[idx]
    if protocol.for_config(cfg).record_struct(cfg)[1] == np.uint8:
        return packing.np_words_to_bytes(rows)
    return rows


# ---------------------------------------------------------------------------
# Parameters, hashes, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    ({"m": 10, "c": 1.0}, "load factor"), ({"m": 0}, "m must be >= 1"),
    ({"m": 4, "n_hashes": 1}, "hash functions"),
    ({"m": 4, "c": -1.0}, "c must be > 0"), ({"m": 4}, None),
    ({"m": 256}, None), ({"m": 5, "c": 3.0}, None)])
def test_params_match_reference(kwargs, match):
    got, want = batch.CuckooParams(**kwargs), ref_batch.CuckooParams(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_buckets, got.load_factor, got.failure_bound()) == \
        (want.n_buckets, want.load_factor, want.failure_bound())
    if match is None:
        assert got.validate() is got
        return
    for p in (got, want):
        with pytest.raises(ValueError, match=match):
            p.validate()


def test_params_from_config_match_reference():
    cfg = PIRConfig(n_items=N, batch_m=4, cuckoo_c=3.0, cuckoo_hashes=2,
                    cuckoo_seed=7)
    assert dataclasses.asdict(batch.CuckooParams.from_config(cfg)) == \
        dataclasses.asdict(ref_batch.CuckooParams.from_config(_ref_cfg(cfg)))
    assert batch.ALPHA_MAX == ref_batch.ALPHA_MAX


@pytest.mark.parametrize("m,seed", [(1, 0x5EEDBA11), (4, 0x5EEDBA11),
                                    (33, 0x5EEDBA11), (256, 1)])
def test_bucket_hashes_match_reference(m, seed):
    idx = np.arange(3 * N)
    got = batch.bucket_hashes(idx, batch.CuckooParams(m=m, seed=seed))
    want = ref_batch.bucket_hashes(idx, ref_batch.CuckooParams(m=m,
                                                               seed=seed))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_items,m,c", [
    (1 << 10, 4, 2.0), (1 << 14, 256, 2.0),
    (3000, 5, 2.0),            # B = 10 buckets (not a power of two), N too
    (1 << 12, 3, 3.0)])        # B = 9
def test_layout_matches_reference_field_by_field(n_items, m, c):
    got = batch.CuckooLayout.build(n_items, batch.CuckooParams(m=m, c=c))
    want = ref_batch.CuckooLayout.build(n_items,
                                        ref_batch.CuckooParams(m=m, c=c))
    assert (got.n_items, got.capacity, got.n_buckets) == \
        (want.n_items, want.capacity, want.n_buckets)
    for name in ("hashes", "slot_of", "loads"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(got.bucket_rows) == len(want.bucket_rows)
    for g, w in zip(got.bucket_rows, want.bucket_rows):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for i in range(0, n_items, 97):
        assert got.occurrences(i) == want.occurrences(i)
        b = got.occurrences(i)[-1][0]
        assert got.slot(i, b) == want.slot(i, b)
    bad = next(b for b in range(got.n_buckets) if b not in got.hashes[0])
    with pytest.raises(KeyError, match="not a candidate"):
        got.slot(0, bad)


# ---------------------------------------------------------------------------
# The client: cuckoo walk and round plans
# ---------------------------------------------------------------------------

LAYOUT = batch.CuckooLayout.build(N, batch.CuckooParams(m=4))
REF_LAYOUT = ref_batch.CuckooLayout.build(N, ref_batch.CuckooParams(m=4))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_cuckoo_assign_matches_reference(seed):
    """The same table, or the same CuckooFailure, and the generator left at
    the same state."""
    idx = np.random.default_rng(seed).choice(N, size=4, replace=False)
    rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    try:
        want = ref_batch.cuckoo_assign(idx, REF_LAYOUT, ref_rng)
    except ref_batch.CuckooFailure as e:
        with pytest.raises(batch.CuckooFailure) as got:
            batch.cuckoo_assign(idx, LAYOUT, rng)
        assert got.value.index == e.index
    else:
        assert batch.cuckoo_assign(idx, LAYOUT, rng) == want
    assert rng.integers(1 << 30) == ref_rng.integers(1 << 30)


def test_cuckoo_assign_rejects_bad_batches():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="unique"):
        batch.cuckoo_assign([1, 1], LAYOUT, rng)
    with pytest.raises(ValueError, match="exceeds m"):
        batch.cuckoo_assign(list(range(5)), LAYOUT, rng)
    for i in range(0, N, 17):          # one index always places
        assert list(batch.cuckoo_assign([i], LAYOUT, rng).values()) == [i]


def _u32(x):
    return (x.numpy().view(np.uint32) if isinstance(x, torch.Tensor)
            else np.asarray(x))


@pytest.mark.parametrize("name,n_servers", BATCH_PROTOCOLS)
def test_plan_round_matches_reference_keys_included(name, n_servers):
    """One seed, the same batches: the same assignment, slots, real flags
    and per-bucket per-party keys (the dummy slot is drawn before each
    bucket's keygen in both), and the generator left at the same state."""
    cfg = _batch_cfg(name, n_servers)
    inner = dataclasses.replace(cfg, n_items=LAYOUT.capacity)
    ref_inner = _ref_cfg(inner)
    proto, ref_proto = protocol.for_config(inner), ref_for_config(ref_inner)
    rng, ref_rng = np.random.default_rng(1), np.random.default_rng(1)
    for idx in ([3, 3, 200, 77], [9]):
        got = batch.plan_round(rng, idx, LAYOUT, inner, proto)
        want = ref_batch.plan_round(ref_rng, idx, REF_LAYOUT, ref_inner,
                                    ref_proto)
        assert got.n_buckets == want.n_buckets == LAYOUT.n_buckets
        assert (got.request_indices, got.bucket_of, got.slots, got.real) == \
            (want.request_indices, want.bucket_of, want.slots, want.real)
        for b in range(got.n_buckets):
            for p in range(n_servers):
                k, r = got.party_keys(p)[b], want.party_keys(p)[b]
                assert (k.party, k.log_n) == (r.party, r.log_n)
                for f in ("root_seed", "cw_seed", "cw_t", "cw_final"):
                    gf, wf = getattr(k, f), getattr(r, f)
                    assert (gf is None) == (wf is None), f
                    if gf is not None:
                        np.testing.assert_array_equal(_u32(gf), _u32(wf),
                                                      err_msg=f)
    assert rng.integers(1 << 30) == ref_rng.integers(1 << 30)


def test_reassemble_fans_duplicates_out():
    inner = dataclasses.replace(_batch_cfg(), n_items=LAYOUT.capacity)
    plan = batch.plan_round(np.random.default_rng(1), [3, 3, 200, 77],
                            LAYOUT, inner, protocol.for_config(inner))
    recs = np.arange(plan.n_buckets)[:, None] * np.ones((1, 8), np.int64)
    out = batch.reassemble(plan, recs)
    want = ref_batch.reassemble(plan, recs)     # the same plan fields
    np.testing.assert_array_equal(out, want)
    assert out[0, 0] == out[1, 0] == plan.bucket_of[3]


# ---------------------------------------------------------------------------
# The bucketed database
# ---------------------------------------------------------------------------

def _bucket_words(bdb, b):
    view = bdb.snapshot(("words",))[1]["words"][b]
    return (packing.tensor_to_words(view) if isinstance(view, torch.Tensor)
            else np.asarray(view))


@pytest.fixture(scope="module")
def bucketed_pair():
    cfg = _batch_cfg()
    return (RefBucketedDatabase(DB, _ref_cfg(cfg), make_local_mesh()),
            BucketedDatabase(DB, cfg, "cpu"))


def test_bucketed_database_views_match_reference(bucketed_pair):
    ref, port = bucketed_pair
    assert (port.n_buckets, port.capacity, port.expansion) == \
        (ref.n_buckets, ref.capacity, ref.expansion)
    assert port.inner_spec == DatabaseSpec(n_items=port.capacity,
                                           item_bytes=32, checksum=True)
    assert port.inner_cfg.n_items == port.capacity
    for b in range(port.n_buckets):
        got = _bucket_words(port, b)
        np.testing.assert_array_equal(got, _bucket_words(ref, b))
        # pad rows: zero payloads with valid checksums
        pad = got[len(port.layout.bucket_rows[b]):]
        assert (pad[:, :-1] == 0).all()
        port.inner_spec.verify_stored_rows(pad)
    assert port.stats.n_full_placements == port.n_buckets
    assert port.resident_bytes == port.n_buckets * port.capacity * 36


def test_bucketed_stage_publish_fan_out_matches_reference():
    cfg = _batch_cfg()
    ref = RefBucketedDatabase(DB, _ref_cfg(cfg), make_local_mesh())
    port = BucketedDatabase(DB, cfg, "cpu")
    assert port.publish() == ref.publish() == 0       # a no-op
    rng = np.random.default_rng(2)
    targets = [123, 5, 123]
    vals = rng.integers(0, 1 << 32, size=(3, 8), dtype=np.uint32)
    assert port.stage(targets, vals) == ref.stage(targets, vals) == 3
    assert port.n_staged == ref.n_staged
    assert port.publish() == ref.publish() == 1 == port.epoch
    for b in range(port.n_buckets):
        np.testing.assert_array_equal(_bucket_words(port, b),
                                      _bucket_words(ref, b))
    touched = {b for t in (123, 5) for b, _ in port.layout.occurrences(t)}
    assert port.stats.n_publishes == len(touched)    # only those cloned
    assert port.stats.clone_device_bytes == \
        len(touched) * port.capacity * 36
    with pytest.raises(ValueError, match="out of range"):
        port.stage([N], vals[:1])


def test_bucketed_database_validates_inputs():
    cfg = PIRConfig(n_items=N, batch_m=4)
    with pytest.raises(ValueError, match="batch size m"):
        BucketedDatabase(DB, PIRConfig(n_items=N), "cpu")
    with pytest.raises(ValueError, match="db_words"):
        BucketedDatabase(DB[: N // 2], cfg, "cpu")
    with pytest.raises(ValueError, match="does not match cfg"):
        BucketedDatabase(DB, cfg, "cpu", layout=batch.CuckooLayout.build(
            N, batch.CuckooParams(m=8)))


# ---------------------------------------------------------------------------
# One expansion for every bucket view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [None, "fused"])
@pytest.mark.parametrize("leaves", [1 << 25, 1 << 8])
@pytest.mark.parametrize("name,n_servers", BATCH_PROTOCOLS)
def test_answer_views_equals_answer_per_view(monkeypatch, name, n_servers,
                                             leaves, path):
    """answer_views (the buckets' leaves expanded together, in groups of
    at most EXPAND_LEAVES leaves) returns what answer() returns view by
    view; a plan that is not materialize answers view by view."""
    from repro_torch.core import server
    monkeypatch.setattr(server, "EXPAND_LEAVES", leaves)
    cfg = PIRConfig(n_items=1 << 7, protocol=name, n_servers=n_servers)
    proto = protocol.for_config(cfg)
    fns = server.BucketedServeFns(cfg, buckets=(1, 2), backend="cpu",
                                  path=path, protocol=proto)
    rng = np.random.default_rng(4)
    views = [torch.from_numpy(pir.make_database(rng, cfg.n_items, 32)
                              .view(np.int32)) for _ in range(4)]
    if proto.db_view == "bytes":
        views = [v.view(torch.int8) for v in views]
    keys = proto.query_gen_batch(rng, rng.integers(0, cfg.n_items, size=8),
                                 cfg)
    for party in range(n_servers):
        got = fns.answer_views(views, keys[party])
        assert got.shape[:2] == (4, 2)
        for b, v in enumerate(views):
            part = server.map_keys(keys[party], lambda x: x[2 * b:2 * b + 2])
            assert torch.equal(got[b], fns.answer(v, part))
    with pytest.raises(ValueError, match="do not split"):
        fns.answer_views(views[:3], keys[0])


# ---------------------------------------------------------------------------
# BatchPIR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_servers", BATCH_PROTOCOLS)
def test_batch_pir_records_match_reference_oracle(name, n_servers):
    """Rounds with duplicates, with checksums verified per bucket, and a
    publish between rounds: records equal the reference database's rows
    (its oracle), every round B wide, tags the outer epoch."""
    cfg = _batch_cfg(name, n_servers)
    ref = RefBucketedDatabase(DB, _ref_cfg(cfg), make_local_mesh())
    system = BatchPIR(DB, cfg, device="cpu",
                      client_rng=np.random.default_rng(3))
    for idx in ([5, N - 1, 17, 5], [0, 1, 2, 3, 4, 5, 6]):
        np.testing.assert_array_equal(system.query_batch(idx),
                                      _oracle(cfg, DB, idx))
    vals = np.random.default_rng(8).integers(0, 1 << 32, size=(2, 8),
                                             dtype=np.uint32)
    ref.stage([9, 17], vals)
    system.update([9, 17], vals)
    assert system.publish() == ref.publish() == system.epoch == 1
    updated = DB.copy()
    updated[[9, 17]] = vals
    fut = system.submit_batch([9, 17, 5])
    system.scheduler.pump()
    np.testing.assert_array_equal(fut.result(),
                                  _oracle(cfg, updated, [9, 17, 5]))
    assert fut.epoch == 1
    for b in range(system.db.n_buckets):
        np.testing.assert_array_equal(_bucket_words(system.db, b),
                                      _bucket_words(ref, b))
    assert all(w == system.db.n_buckets for _, w in system.dispatch_log)


def test_dispatch_log_is_b_wide_for_every_batch():
    cfg = _batch_cfg()
    system = BatchPIR(DB, cfg, device="cpu",
                      client_rng=np.random.default_rng(11))
    batches = [[0, 1, 2, 3], [7, 19, 42, 63], [5], [9, 9, 9, 9],
               [N - 4, N - 3, N - 2, N - 1]]
    for idx in batches:
        np.testing.assert_array_equal(system.query_batch(idx),
                                      _oracle(cfg, DB, idx))
    assert len(system.dispatch_log) >= len(batches)
    assert {w for _, w in system.dispatch_log} == {system.db.n_buckets}


def test_query_batch_splits_and_retries_on_cuckoo_failure(monkeypatch):
    """A batch whose placement fails is halved until it places; every
    record still comes back in request order."""
    cfg = _batch_cfg()
    system = BatchPIR(DB, cfg, device="cpu",
                      client_rng=np.random.default_rng(12))
    real_plan = runtime_batch.plan_round
    tried = []

    def plan(rng, indices, *args):
        tried.append(len(set(indices)))
        if len(set(indices)) > 1:
            raise batch.CuckooFailure("forced", index=indices[0])
        return real_plan(rng, indices, *args)

    monkeypatch.setattr(runtime_batch, "plan_round", plan)
    idx = [40, 41, 42, 43, 41]
    np.testing.assert_array_equal(system.query_batch(idx),
                                  _oracle(cfg, DB, idx))
    assert tried == [4, 2, 1, 1, 2, 1, 1]
    assert len(system.dispatch_log) == 4
    assert system.query_batch([]).shape == (0, 8)


def test_batch_pir_refuses_hint_protocols_and_plain_configs():
    with pytest.raises(ValueError, match="hint plumbing"):
        BatchPIR(DB, PIRConfig(n_items=N, protocol="lwe-simple-1",
                               n_servers=1, batch_m=4), device="cpu")
    with pytest.raises(ValueError, match="batch_m >= 1"):
        BatchPIR(DB, PIRConfig(n_items=N), device="cpu")
    system = BatchPIR(DB, _batch_cfg(), device="cpu")
    with pytest.raises(ValueError, match="exceeds m"):
        system.submit_batch([1, 2, 3, 4, 5])
    with pytest.raises(ValueError, match="out of range"):
        system.submit_batch([N])


def test_single_index_submit_is_a_full_round():
    cfg = _batch_cfg(name="additive-dpf-2")
    system = BatchPIR(DB, cfg, device="cpu",
                      client_rng=np.random.default_rng(13))
    with system:
        futs = [system.submit(i) for i in (3, 200)]
        recs = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(np.stack(recs), _oracle(cfg, DB, [3, 200]))
    assert [f.epoch for f in futs] == [0, 0]
    assert all(w == system.db.n_buckets for _, w in system.dispatch_log)


def test_batch_query_twin_on_cpu():
    res = batch_query.run(device="cpu", verbose=False)
    assert (res["epoch"], res["tag"], res["n_buckets"]) == (1, 1, 8)
    assert {w for _, w in res["dispatch_log"]} == {8}
