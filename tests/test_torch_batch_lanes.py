"""Port parity: ``BatchPIR`` with two logical lanes (``n_clusters=2``)
against the reference's, at ``PIR_SMOKE_BATCH`` on the CPU.

Both facades get the same records and the same client seed, so their
cuckoo plans and keys are equal (``tests/test_torch_batch.py``). Rounds
submitted before a pump are spread over the lanes round-robin; the
records, the dispatch log and each lane's batch count must be equal.
A lane's batches are counted where its scheduler records their latency
(``StragglerMonitor.record``), the same seam in both packages.
"""
from collections import Counter

import numpy as np
import pytest

from repro.config import PIRConfig as RefPIRConfig
from repro.launch.mesh import make_local_mesh
from repro.runtime.batch import BatchPIR as RefBatchPIR
from repro_torch.configs.pir import PIR_SMOKE_BATCH
from repro_torch.core import pir
from repro_torch.runtime.batch import BatchPIR

CFG = PIR_SMOKE_BATCH
DB = pir.make_database(np.random.default_rng(71), CFG.n_items,
                       CFG.item_bytes)


def _count_lanes(system) -> Counter:
    """Count each lane's completed batches at the monitor's record."""
    lanes = Counter()
    monitor = system.scheduler.monitor
    record = monitor.record

    def counting(participant, latency):
        lanes[participant] += 1
        record(participant, latency)

    monitor.record = counting
    return lanes


def _serve(system, rounds):
    """Submit every round before pumping once; the records in order."""
    lanes = _count_lanes(system)
    futs = [system.submit_batch(idx) for idx in rounds]
    system.scheduler.pump()
    return [np.asarray(f.result(timeout=300)) for f in futs], lanes


@pytest.fixture(scope="module")
def served():
    rounds = [[5, 900, 17, 5], [1023, 0, 64, 300], [77]]
    ref = RefBatchPIR(DB, RefPIRConfig(**CFG.to_dict()), make_local_mesh(),
                      n_clusters=2, client_rng=np.random.default_rng(72))
    port = BatchPIR(DB, CFG, device="cpu", n_clusters=2,
                    client_rng=np.random.default_rng(72))
    return rounds, (ref, _serve(ref, rounds)), (port, _serve(port, rounds))


def test_two_lane_records_match_reference(served):
    rounds, (_, (ref_recs, _)), (_, (recs, _)) = served
    for idx, want, got in zip(rounds, ref_recs, recs):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, DB[idx])


def test_two_lane_dispatch_log_matches_reference(served):
    _, (ref, _), (port, _) = served
    assert port.dispatch_log == ref.dispatch_log
    assert all(w == port.db.n_buckets for _, w in port.dispatch_log)


def test_every_lane_carries_the_reference_batches(served):
    _, (ref, (_, ref_lanes)), (port, (_, lanes)) = served
    assert set(port.scheduler.queues) == {"cluster0", "cluster1"}
    assert lanes == ref_lanes
    assert lanes["cluster0"] >= 1 and lanes["cluster1"] >= 1
    assert sum(lanes.values()) == len(port.dispatch_log)
    assert port.scheduler.queue_depth == 0


def test_one_lane_is_the_default():
    system = BatchPIR(DB, CFG, device="cpu",
                      client_rng=np.random.default_rng(73))
    assert set(system.scheduler.queues) == {"cluster0"}
