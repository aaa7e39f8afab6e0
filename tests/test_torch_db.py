"""Port parity: the database plane's online updates (repro_torch vs repro).

The same numpy rows go through the reference's ``ShardedDatabase`` (on
``make_local_mesh()``, eager and tiny-jit only, as ``tests/test_db.py``
runs it) and the port's ``Database``: staging, last-write-wins publishes,
the ``PublishedDelta`` subscribers receive, the three views after random
writes, the host-to-device accounting, the retired epoch, the LWE hint's
exact delta, and records served after updates for all four schemes. All of
it is integer arithmetic, so every comparison is exact equality.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro.config import PIRConfig as RefPIRConfig
from repro.core import lwe as ref_lwe
from repro.core.protocol import for_config as ref_for_config
from repro.db import DatabaseSpec as RefDatabaseSpec, ShardedDatabase
from repro.launch.mesh import make_local_mesh
from repro_torch import db_updates
from repro_torch.config import PIRConfig
from repro_torch.core import lwe, pir, protocol
from repro_torch.crypto import packing
from repro_torch.db import Database, DatabaseSpec, PublishedDelta
from repro_torch.kernels import lwe_matmul as kl
from repro_torch.runtime.serve_loop import (AnswerFuture, MultiServerPIR,
                                            QueryScheduler, QueryTimeout,
                                            SingleServerPIR, TwoServerPIR)

LOG_N = 6
N = 1 << LOG_N
DB = pir.make_database(np.random.default_rng(0), N, 32)


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


def _ref_cfg(cfg: PIRConfig) -> RefPIRConfig:
    return RefPIRConfig(**cfg.to_dict())


def _pair(mesh, cfg=None, words=DB):
    """The reference's and the port's database over the same rows."""
    cfg = cfg or PIRConfig(n_items=len(words))
    return (ShardedDatabase(words, _ref_cfg(cfg), mesh),
            Database(words, cfg, "cpu"))


def _rand_rows(rng, n_rows, n_items=N, words=8):
    rows = rng.choice(n_items, size=n_rows, replace=False)
    vals = rng.integers(0, 1 << 32, size=(n_rows, words), dtype=np.uint32)
    return rows, vals


def _stage_both(ref, port, rows, vals):
    assert ref.stage(rows, vals) == port.stage(rows, vals)


def _views_equal(ref, port, epoch=None):
    np.testing.assert_array_equal(
        packing.tensor_to_words(port.view("words", epoch=epoch)),
        np.asarray(ref.view("words", epoch=epoch)))
    np.testing.assert_array_equal(
        port.view("bytes", epoch=epoch).numpy().view(np.uint8),
        np.asarray(ref.view("bytes", epoch=epoch)).view(np.uint8))
    np.testing.assert_array_equal(
        port.view("bytes32", epoch=epoch).numpy(),
        np.asarray(ref.view("bytes32", epoch=epoch)))


# ---------------------------------------------------------------------------
# Staging and publishing
# ---------------------------------------------------------------------------

def test_coerce_update_rows_matches_reference():
    spec = DatabaseSpec(n_items=N, item_bytes=32)
    ref = RefDatabaseSpec(n_items=N, item_bytes=32)
    words = np.random.default_rng(1).integers(0, 1 << 32, size=(3, 8),
                                              dtype=np.uint32)
    as_bytes = packing.np_words_to_bytes(words)
    for values in (words, as_bytes, words.astype(np.int64)):
        got = spec.coerce_rows_to_words(values)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref.coerce_rows_to_words(values))
    for bad, match in ((words[0], "2-D"), (np.zeros((3, 5), np.uint32),
                                           "row values")):
        with pytest.raises(ValueError, match=match):
            spec.coerce_rows_to_words(bad)
        with pytest.raises(ValueError, match=match):
            ref.coerce_rows_to_words(bad)


def test_stage_validates_and_publish_applies_last_write_wins(mesh):
    ref, port = _pair(mesh)
    for db in (ref, port):
        with pytest.raises(ValueError, match="out of range"):
            db.stage([N], np.zeros((1, 8), np.uint32))
        with pytest.raises(ValueError, match="mismatch"):
            db.stage([1, 2], np.zeros((1, 8), np.uint32))
    rng = np.random.default_rng(2)
    v1, v2 = (rng.integers(0, 1 << 32, size=(1, 8), dtype=np.uint32)
              for _ in range(2))
    _stage_both(ref, port, [9], v1)
    _stage_both(ref, port, [9], v2)           # the same row twice
    assert port.n_staged == ref.n_staged == 2
    assert port.publish() == ref.publish() == 1
    assert port.n_staged == 0
    expect = DB.copy()
    expect[9] = v2                            # the later write wins
    np.testing.assert_array_equal(
        packing.tensor_to_words(port.view("words")), expect)
    _views_equal(ref, port)
    assert port.published[-1].n_staged == 2
    np.testing.assert_array_equal(port.published[-1].rows, [9])
    # publishing nothing, or only zero-row stages, makes no new epoch
    assert port.publish() == ref.publish() == 1
    _stage_both(ref, port, np.zeros((0,), np.int64),
                np.zeros((0, 8), np.uint32))
    assert port.publish() == ref.publish() == 1
    assert port.stats.n_publishes == ref.stats.n_publishes == 1


def test_subscribers_get_the_reference_delta_and_replay_it(mesh):
    """Every publish hands subscribers a PublishedDelta equal to the
    reference's; replayed into a second database it reproduces the epoch;
    unsubscribing stops delivery."""
    ref, src = _pair(mesh)
    dst = Database(DB, PIRConfig(n_items=N), "cpu")
    seen, ref_seen = [], []
    unsubscribe = src.subscribe(seen.append)
    ref.subscribe(ref_seen.append)
    src.subscribe(lambda d: dst.stage(d.rows, d.vals) and dst.publish())
    rng = np.random.default_rng(3)
    v1, v2 = (rng.integers(0, 1 << 32, size=(1, 8), dtype=np.uint32)
              for _ in range(2))
    for rows, vals in (([9], v1), ([9], v2), ([3], v1)):
        _stage_both(ref, src, rows, vals)
    assert src.publish() == ref.publish() == 1
    assert src.publish() == 1                  # a no-op: no callback
    assert len(seen) == len(ref_seen) == 1
    got, want = seen[0], ref_seen[0]
    assert isinstance(got, PublishedDelta)
    assert (got.epoch, got.n_staged) == (want.epoch, want.n_staged) == (1, 3)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.vals, want.vals)
    assert got.vals.shape == (2, 8)            # deduplicated, logical
    assert dst.epoch == 1
    assert torch.equal(dst.view("words"), src.view("words"))
    unsubscribe()
    src.stage([0], v1)
    src.publish()
    assert len(seen) == 1 and dst.epoch == 2
    assert torch.equal(dst.view("words"), src.view("words"))


@pytest.mark.parametrize("checksum", [False, True])
def test_views_after_random_writes_match_reference(mesh, checksum):
    """words, bytes (an alias of the words) and bytes32 (a copy, built
    once and then maintained by each publish) equal the reference's views
    after each of three publishes of random rows, byte rows included."""
    cfg = PIRConfig(n_items=N, checksum=checksum)
    ref, port = _pair(mesh, cfg)
    port.view("bytes32")
    ref.view("bytes32")
    assert port.stats.n_view_packs == 1
    rng = np.random.default_rng(23)
    for i in range(3):
        rows, vals = _rand_rows(rng, 5)
        values = packing.np_words_to_bytes(vals) if i == 1 else vals
        _stage_both(ref, port, rows, values)
        assert port.publish() == ref.publish() == i + 1
        _views_equal(ref, port)
    assert port.stats.n_view_packs == 1       # never rebuilt from scratch
    assert port.stats.n_full_placements == 1  # never placed again
    assert port.stats.n_publishes == 3


@pytest.mark.parametrize("n_items", [1 << 8, 1 << 12])
def test_host_to_device_bytes_grow_with_rows_not_db(mesh, n_items):
    """A publish of R rows sends R int32 indices and R stored rows, whatever
    N is; at a power-of-two R (the reference pads R to one) that is the
    reference's count. The device copy is the O(N) part, on the card."""
    words = pir.make_database(np.random.default_rng(1), n_items, 32)
    cfg = PIRConfig(n_items=n_items)
    ref, port = _pair(mesh, cfg, words)
    sent = []
    for r in (1, 3, 4, 16):
        before = port.stats.update_h2d_bytes
        rows, vals = _rand_rows(np.random.default_rng(r), r, n_items)
        port.stage(rows, vals)
        port.publish()
        sent.append(port.stats.update_h2d_bytes - before)
    assert sent == [r * (4 + 32) for r in (1, 3, 4, 16)]
    assert port.stats.preload_h2d_bytes == words.nbytes
    assert port.stats.clone_device_bytes == 4 * words.nbytes
    rows, vals = _rand_rows(np.random.default_rng(9), 4, n_items)
    ref.stage(rows, vals)
    ref.publish()
    assert ref.stats.update_h2d_bytes == sent[2]


def test_previous_epoch_pinned_and_older_released(mesh):
    ref, port = _pair(mesh)
    v0 = port.view("words")
    rows, vals = _rand_rows(np.random.default_rng(3), 2)
    _stage_both(ref, port, rows, vals)
    assert port.publish() == ref.publish() == 1
    assert port.resident_bytes == 2 * DB.nbytes    # both epochs' words
    # the tensor captured before the publish was not written
    np.testing.assert_array_equal(packing.tensor_to_words(v0), DB)
    _views_equal(ref, port, epoch=0)
    _views_equal(ref, port, epoch=1)
    assert port.resident_bytes == 2 * 5 * DB.nbytes   # and bytes32 (4x)
    _stage_both(ref, port, rows[:1], vals[:1] ^ 1)
    assert port.publish() == ref.publish() == 2
    for db in (ref, port):
        with pytest.raises(KeyError, match="not resident"):
            db.view("words", epoch=0)
    _views_equal(ref, port, epoch=1)


# ---------------------------------------------------------------------------
# Epoch tags across a publish
# ---------------------------------------------------------------------------

def test_scheduler_tags_answers_with_dispatch_epoch():
    """A publish landing after a batch's dispatch read its snapshot neither
    changes its rows nor its tag; the next batch reads and is tagged with
    the new epoch."""
    db = Database(DB, PIRConfig(n_items=N), "cpu")
    new_val = np.random.default_rng(4).integers(0, 1 << 32, size=(1, 8),
                                                dtype=np.uint32)
    state = {"publish_mid_flight": True}

    def dispatch(staged):
        epoch, views = db.snapshot(("words",))
        if state["publish_mid_flight"]:
            db.stage([0], new_val)
            db.publish()
            state["publish_mid_flight"] = False
        return views["words"], staged, epoch

    sched = QueryScheduler(
        collate=list, stage=lambda p: p, dispatch=dispatch,
        finalize=lambda raw, n: [packing.tensor_to_words(raw[0][i])
                                 for i in raw[1][:n]],
        buckets=(2,), epoch_of=lambda raw: raw[2])
    first = [sched.submit(0), sched.submit(3)]
    sched.pump()
    assert [f.epoch for f in first] == [0, 0]
    np.testing.assert_array_equal(first[0].result(0), DB[0])
    np.testing.assert_array_equal(first[1].result(0), DB[3])
    assert db.epoch == 1
    second = [sched.submit(0), sched.submit(3)]
    sched.pump()
    assert [f.epoch for f in second] == [1, 1]
    np.testing.assert_array_equal(second[0].result(0), new_val[0])
    np.testing.assert_array_equal(second[1].result(0), DB[3])


def test_snapshot_before_publish_still_serves_old_rows():
    cfg = PIRConfig(n_items=N)
    system = TwoServerPIR(DB, cfg, device="cpu", n_queries=2,
                          client_rng=np.random.default_rng(5))
    epoch, views = system.db.snapshot()
    rows, vals = _rand_rows(np.random.default_rng(6), 4)
    system.update(rows, vals)
    assert system.publish() == 1
    idx = [int(r) for r in rows[:2]]
    keys = system.protocol.query_gen_batch(system.rng, idx, cfg)
    answers = [s.bucketed.answer(views["words"], k)
               for s, k in zip(system.servers, keys)]
    old = packing.records_to_host(system.protocol.reconstruct(answers))
    assert epoch == 0
    np.testing.assert_array_equal(old, DB[idx])
    np.testing.assert_array_equal(system.query(idx), vals[:2])


def test_publishers_and_readers_race_without_torn_epochs():
    """Four threads stage and publish while four read snapshots, with a
    short switch interval: every snapshot's rows are exactly its epoch's
    (replayed from the published deltas), and epochs are consecutive."""
    db = Database(DB, PIRConfig(n_items=N), "cpu")
    deltas = {}
    db.subscribe(lambda d: deltas.__setitem__(d.epoch, d))
    reads, errors = [], []

    def writer(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(15):
                rows, vals = _rand_rows(rng, 3)
                db.stage(rows, vals)
                db.publish()
        except Exception as e:      # surfaced by the assertion below
            errors.append(e)

    def reader():
        for _ in range(60):
            epoch, views = db.snapshot()
            reads.append((epoch, views["words"].clone()))

    threads = ([threading.Thread(target=writer, args=(s,)) for s in range(4)]
               + [threading.Thread(target=reader) for _ in range(4)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(deltas) == list(range(1, db.epoch + 1))
    state = {0: DB.copy()}
    for e in range(1, db.epoch + 1):
        state[e] = state[e - 1].copy()
        state[e][deltas[e].rows] = deltas[e].vals
    assert len(reads) == 240
    for epoch, words in reads:
        np.testing.assert_array_equal(packing.tensor_to_words(words),
                                      state[epoch])


# ---------------------------------------------------------------------------
# Records served after updates, every scheme
# ---------------------------------------------------------------------------

SCHEMES = [("xor-dpf-2", 2), ("additive-dpf-2", 2), ("xor-dpf-k", 3),
           ("lwe-simple-1", 1)]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("name,n_servers", SCHEMES)
def test_update_then_query_parity(mesh, name, n_servers, checksum):
    """The same writes staged and published on the reference's database
    and through the port's deployment: the port serves exactly the
    reference's published rows, updated and untouched alike."""
    cfg = PIRConfig(n_items=N, protocol=name, n_servers=n_servers,
                    checksum=checksum)
    ref = ShardedDatabase(DB, _ref_cfg(cfg), mesh)
    cls = SingleServerPIR if n_servers == 1 else MultiServerPIR
    system = cls(DB, cfg, device="cpu", n_queries=4,
                 client_rng=np.random.default_rng(7))
    rows, vals = _rand_rows(np.random.default_rng(31), 3)
    ref.stage(rows, vals)
    system.update(rows, vals)
    assert system.publish() == ref.publish() == 1
    idx = [int(rows[0]), int(rows[2]), int((rows[0] + 1) % N)]
    assert idx[2] not in rows
    got = system.query(idx)
    oracle = np.asarray(ref.view("words"))[idx][:, :8]     # logical width
    if system.protocol.record_struct(cfg)[1] == np.uint8:
        oracle = packing.np_words_to_bytes(oracle)
    np.testing.assert_array_equal(got, oracle)
    futs = [system.submit(i) for i in idx[:2]]
    system.scheduler.pump()
    assert [f.epoch for f in futs] == [1, 1]


# ---------------------------------------------------------------------------
# The LWE hint across publishes
# ---------------------------------------------------------------------------

def _lwe_pair(mesh, n_items=1 << 8, checksum=False, delta=True):
    cfg = PIRConfig(n_items=n_items, protocol="lwe-simple-1", n_servers=1,
                    checksum=checksum)
    words = pir.make_database(np.random.default_rng(8), n_items, 32)
    ref, port = _pair(mesh, cfg, words)
    rproto, proto = ref_for_config(_ref_cfg(cfg)), protocol.for_config(cfg)
    ref.register_hint(rproto.name, rproto.hint_builder(_ref_cfg(cfg)),
                      rproto.hint_delta(_ref_cfg(cfg)))
    port.register_hint(proto.name, proto.hint_builder(cfg),
                       proto.hint_delta(cfg) if delta else None)
    return ref, port, proto, cfg


def test_hint_built_lazily_once_per_epoch(mesh):
    ref, port, proto, cfg = _lwe_pair(mesh)
    assert port.stats.n_hint_builds == 0
    h = port.hint(proto.name)
    assert port.hint(proto.name) is h and port.n_hint_builds == 1
    rows, vals = _rand_rows(np.random.default_rng(9), 2, cfg.n_items)
    port.stage(rows, vals)
    port.publish()
    port.hint(proto.name)
    assert port.stats.n_hint_builds == 1 and port.stats.n_hint_deltas == 1
    assert port.hint(proto.name, epoch=0) is h      # the retired hint


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("n_rows", [1, 3, 64])
def test_hint_delta_matches_rebuild_and_reference(mesh, n_rows, checksum):
    """The delta-updated hint (one int32 GEMM with K padded to a multiple
    of 4 by zero rows) equals a full rebuild and the reference's
    delta-updated hint, byte for byte, at R = 1, 3 and 64."""
    ref, port, proto, cfg = _lwe_pair(mesh, checksum=checksum)
    ref.hint(proto.name)
    before = port.hint(proto.name)
    rows, vals = _rand_rows(np.random.default_rng(n_rows), n_rows,
                            cfg.n_items)
    _stage_both(ref, port, rows, vals)
    assert port.publish() == ref.publish() == 1
    got = port.hint(proto.name)
    assert port.stats.n_hint_builds == 1 and port.stats.n_hint_deltas == 1
    assert torch.equal(got, proto.hint_builder(cfg)(port.view("words")))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.hint(proto.name)))
    assert port.hint(proto.name, epoch=0) is before


def test_hint_without_delta_is_dropped_and_rebuilt(mesh):
    ref, port, proto, cfg = _lwe_pair(mesh, delta=False)
    port.hint(proto.name)
    rows, vals = _rand_rows(np.random.default_rng(10), 4, cfg.n_items)
    port.stage(rows, vals)
    port.publish()
    assert port.stats.n_hint_builds == 1 and port.stats.n_hint_deltas == 0
    got = port.hint(proto.name)
    assert port.stats.n_hint_builds == 2
    want = ref_lwe.hint_np(
        ref_lwe.params_for(cfg.n_items),
        packing.np_words_to_bytes(packing.tensor_to_words(
            port.view("words"))))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.astype(np.uint32))


def test_stale_client_hint_cache_refreshes_on_epoch_bump():
    cfg = PIRConfig(n_items=1 << 8, protocol="lwe-simple-1", n_servers=1)
    words = pir.make_database(np.random.default_rng(11), cfg.n_items, 32)
    system = SingleServerPIR(words, cfg, device="cpu", n_queries=2,
                             client_rng=np.random.default_rng(12))
    np.testing.assert_array_equal(system.query([5]),
                                  packing.np_words_to_bytes(words[[5]]))
    assert system.hint_fetches == 1
    rows, vals = _rand_rows(np.random.default_rng(13), 3, cfg.n_items)
    system.update(rows, vals)
    assert system.publish() == 1
    np.testing.assert_array_equal(system.query(rows.tolist()),
                                  packing.np_words_to_bytes(vals))
    assert system.hint_fetches == 2
    assert system.db.stats.n_hint_builds == 1      # the server's delta
    assert system.db.stats.n_hint_deltas == 1


# ---------------------------------------------------------------------------
# Sessions, deadlines, the twin
# ---------------------------------------------------------------------------

def test_two_server_session_serves_updates():
    cfg = PIRConfig(n_items=N)
    system = TwoServerPIR(DB, cfg, device="cpu", n_queries=2,
                          client_rng=np.random.default_rng(14))
    rows, vals = _rand_rows(np.random.default_rng(15), 2)
    with system:
        before = system.submit(int(rows[0]))
        np.testing.assert_array_equal(before.result(timeout=120), DB[rows[0]])
        system.update(rows, vals)
        epoch = system.publish()
        after = [system.submit(int(r)) for r in rows]
        got = [f.result(timeout=120) for f in after]
        np.testing.assert_array_equal(system.query_batch([int(rows[1])]),
                                      vals[1:])
    assert before.epoch == 0 and epoch == system.epoch == 1
    assert [f.epoch for f in after] == [1, 1]
    np.testing.assert_array_equal(np.stack(got), vals)


def test_answer_future_deadline_callbacks_and_given_future():
    fut = AnswerFuture(deadline=0.0)
    fut.context["bucket"] = 4
    with pytest.raises(QueryTimeout, match="bucket=4") as exc:
        fut.result()
    assert isinstance(exc.value, TimeoutError)
    seen = []
    fut.add_done_callback(seen.append)
    assert fut.set_result(7) and not fut.set_exception(RuntimeError())
    fut.add_done_callback(seen.append)         # already done: at once
    assert seen == [fut, fut] and fut.result() == 7
    sched = QueryScheduler(collate=list, stage=lambda p: p,
                           dispatch=lambda s: s,
                           finalize=lambda raw, n: raw[:n], buckets=(1,))
    given = AnswerFuture()
    assert sched.submit(3, future=given) is given
    sched.pump()
    assert given.result(0) == 3


def test_deployments_stamp_default_deadlines():
    cfg = PIRConfig(n_items=N, protocol="xor-dpf-k", n_servers=3,
                    batch_m=4)                 # batch_m is BatchPIR's, not refused
    system = MultiServerPIR(DB, cfg, device="cpu", n_queries=2,
                            client_rng=np.random.default_rng(16))
    assert system.default_deadline_s == 360.0
    fut = system.submit(3, deadline_s=50.0)
    assert 0 < fut.deadline - fut.created <= 50.0
    system.scheduler.pump()
    np.testing.assert_array_equal(fut.result(), DB[3])


def test_db_updates_twin_on_cpu():
    res = db_updates.run(device="cpu", verbose=False)
    assert res["epoch"] == 1 and res["tags"] == [1, 1]
    assert res["update_h2d_bytes"] == 4 + 32


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card; "
                    "chip_smoke.py's updates_lwe holds the same shapes at "
                    "full size)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [32, 36])
@pytest.mark.parametrize("r4", [4, 64, 4096])
def test_hint_delta_gemm_on_the_card(card, r4, cols):
    """The delta's shape on B5: Delta^T [L, R4] x A[rows] [R4, 1024], K as
    small as 4, full-range int32 operands, against the plain version."""
    gen = torch.Generator(device=card).manual_seed(r4 + cols)
    d_t = torch.randint(-(1 << 31), (1 << 31) - 1, (cols, r4), generator=gen,
                        device=card, dtype=torch.int32)
    a = torch.randint(-(1 << 31), (1 << 31) - 1, (r4, 1024), generator=gen,
                      device=card, dtype=torch.int32)
    assert torch.equal(kl.lwe_gemm(d_t, a), kl.lwe_gemm_plain(d_t, a))


@pytest.mark.cuda
def test_publish_during_a_running_session_on_the_card(card):
    """A session serves while another thread publishes: every answer is
    exactly its tagged epoch's row, on the card's kernels."""
    cfg = PIRConfig(n_items=1 << 12)
    words = pir.make_database(np.random.default_rng(17), cfg.n_items, 32)
    system = TwoServerPIR(words, cfg, device=card, n_queries=4,
                          client_rng=np.random.default_rng(18))
    target = 77
    history = {0: words[target].copy()}

    def publisher():
        rng = np.random.default_rng(19)
        for _ in range(10):
            v = rng.integers(0, 1 << 32, size=(1, 8), dtype=np.uint32)
            system.update([target], v)
            history[system.publish()] = v[0]

    with system:
        t = threading.Thread(target=publisher)
        t.start()
        futs = [system.submit(target) for _ in range(40)]
        t.join(timeout=120)
        got = [(f.result(timeout=120), f.epoch) for f in futs]
    assert not t.is_alive() and system.epoch == 10
    for rec, epoch in got:
        np.testing.assert_array_equal(rec, history[epoch])
