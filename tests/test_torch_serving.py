"""Port: the served slice end to end on the CPU (plain kernel versions).

``TwoServerPIR`` of the port returns the reference database's records
(same seed, same draw), for ragged batches, batches past the largest
bucket, and a background session; the scheduler's lifecycle matches the
reference's contract.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core import pir as ref_pir
from repro_torch import quickstart
from repro_torch.config import PIRConfig
from repro_torch.core import dpf, pir
from repro_torch.core.server import PIRServer, bucket_for, default_buckets
from repro_torch.db import Database, DatabaseSpec
from repro_torch.kernels import ops
from repro_torch.runtime.serve_loop import (AnswerFuture, QueryScheduler,
                                            TwoServerPIR)

CFG = PIRConfig(n_items=1 << 10, item_bytes=32, batch_queries=4)


@pytest.fixture(scope="module")
def db():
    return pir.make_database(np.random.default_rng(0), CFG.n_items,
                             CFG.item_bytes)


@pytest.fixture(scope="module")
def system(db):
    return TwoServerPIR(db, CFG, device="cpu", n_queries=4,
                        client_rng=np.random.default_rng(1))


def test_make_database_matches_reference(db):
    ref = ref_pir.make_database(np.random.default_rng(0), CFG.n_items,
                                CFG.item_bytes)
    np.testing.assert_array_equal(db, ref)


@pytest.mark.parametrize("n", [1, 3, 4, 9])
def test_query_returns_reference_records(system, db, n):
    """Ragged sizes pad to a bucket; 9 > the largest bucket is chunked."""
    idx = list(np.random.default_rng(n).integers(0, CFG.n_items, size=n))
    got = system.query(idx)
    assert got.dtype == np.uint32 and got.shape == (n, 8)
    np.testing.assert_array_equal(got, db[idx])


def test_query_pads_to_buckets(system, db):
    stats = system.scheduler.stats
    padded0 = stats.padded
    system.query([1, 2, 3])                 # bucket 4: one pad slot
    assert stats.padded - padded0 == 1
    assert system.servers[0].buckets == (1, 2, 4)


def test_query_edges(system, db):
    assert system.query([]).shape == (0, 8)
    np.testing.assert_array_equal(system.query([CFG.n_items - 1]),
                                  db[[CFG.n_items - 1]])
    with pytest.raises(ValueError, match="out of domain"):
        system.query([CFG.n_items])


def test_session_answers_and_lifecycle(db):
    system = TwoServerPIR(db, CFG, device="cpu", n_queries=4,
                          client_rng=np.random.default_rng(2))
    system.close()                          # close before start: no-op
    with system:
        futs = [system.submit(i) for i in (5, 77, 1023, 5, 600)]
        recs = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(np.stack(recs), db[[5, 77, 1023, 5, 600]])
    assert all(f.epoch == 0 for f in futs)
    system.close()                          # double close
    with pytest.raises(RuntimeError, match="stopped"):
        system.submit(3)


def test_session_concurrent_clients(db):
    system = TwoServerPIR(db, CFG, device="cpu", n_queries=4,
                          client_rng=np.random.default_rng(3))
    out = {}

    def client(i):
        out[i] = system.submit(i * 31).result(timeout=120)

    with system:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(6):
        np.testing.assert_array_equal(out[i], db[i * 31])


def test_no_card_raises_instead_of_cpu(db):
    """device=None means CUDA: without a card the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoServerPIR(db, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PIRServer(0, db, CFG)


def test_cpu_serving_uses_plain_versions_only(db):
    system = TwoServerPIR(db, CFG, device="cpu", n_queries=4, path="cuda",
                          client_rng=np.random.default_rng(4))
    ops.reset_counts()
    np.testing.assert_array_equal(system.query([9, 10]), db[[9, 10]])
    counts = ops.counts()["dpxor"]
    assert counts["launches"] == 0 and counts["plain_calls"] == 2


def test_quickstart_twin_on_cpu():
    res = quickstart.run(device="cpu", verbose=False)
    assert res["exact"] == [True] * 4
    assert res["indices"] == [7, 4242, 9000, (1 << 14) - 1]


# ---------------------------------------------------------------------------
# Server, database and scheduler pieces
# ---------------------------------------------------------------------------

def test_server_plans_and_chunking(db):
    server = PIRServer(0, db, CFG, device="cpu", n_queries=2)
    # 2^10 rows <= 2^chunk_log: every bucket materializes (plan_for)
    assert {b: r["plan"] for b, r in server.plan_report().items()} == {
        1: "materialize/torch", 2: "materialize/torch"}
    k0, _ = dpf.gen_keys_batch(np.random.default_rng(6), [1, 2, 3, 4, 5],
                               CFG.log_n)
    assert server.answer(k0).shape == (5, 8)


def test_bucket_rules():
    assert default_buckets(max_bucket=32) == (1, 2, 4, 8, 16, 32)
    assert default_buckets(2, 8) == (2, 4, 8)
    assert bucket_for((1, 2, 4), 3) == 4
    assert bucket_for((1, 2, 4), 9) == 4


def test_database_views_and_validation(db):
    database = Database(db, CFG, "cpu")
    assert database.epoch == 0
    assert database.resident_bytes == db.nbytes
    epoch, views = database.snapshot()
    assert epoch == 0 and views["words"] is database.view()
    assert database.view("bytes").shape == (CFG.n_items, CFG.item_bytes)
    assert database.resident_bytes == db.nbytes     # bytes alias the words
    with pytest.raises(KeyError):
        database.view("nonsense")
    with pytest.raises(ValueError):
        Database(db[:5], CFG, "cpu")
    # a checksummed config stores one more word per record (verified
    # reconstruction); the logical width stays item_bytes
    spec = DatabaseSpec.from_config(PIRConfig(n_items=64, checksum=True))
    assert spec.view_shape("words") == (64, 9)
    assert spec.view_shape("bytes") == (64, 36)
    with pytest.raises(ValueError):
        DatabaseSpec(n_items=96)


def test_scheduler_pipelines_and_fails_futures():
    order = []
    sched = QueryScheduler(
        collate=list, stage=lambda p: p,
        dispatch=lambda s: (order.append(("dispatch", len(s))), s)[1],
        finalize=lambda raw, n: (order.append(("finalize", n)), raw[:n])[1],
        buckets=(1, 2))
    futs = [sched.submit(i) for i in range(5)]
    assert sched.pump() == 5
    assert [f.result(timeout=1) for f in futs] == list(range(5))
    # depth 2: the second batch is dispatched before the first is waited on
    assert order[:3] == [("dispatch", 2), ("dispatch", 2), ("finalize", 2)]

    def boom(_):
        raise RuntimeError("dispatch failed")

    bad = QueryScheduler(collate=list, stage=lambda p: p, dispatch=boom,
                         finalize=lambda raw, n: raw, buckets=(2,))
    fut = bad.submit(1)
    with pytest.raises(RuntimeError):
        bad.pump()
    assert isinstance(fut.exception(), RuntimeError)


def test_answer_future_first_wins():
    fut = AnswerFuture()
    assert fut.set_result(1) and not fut.set_exception(RuntimeError())
    assert fut.done() and fut.result() == 1
    with pytest.raises(TimeoutError):
        AnswerFuture().result(timeout=0.01)
