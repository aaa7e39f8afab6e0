"""Sessions of the single-server LWE scheme and of the batch plane over a
database sharded on a mesh, held against the reference's 4-device
sessions.

Four ``gloo`` ranks (``tests/_torch_ranks.py``), rank 0 the controller,
play the reference's scripts (``tests/_ref_sharded.py``) on the ``(1, 4)``,
``(2, 2)`` and ``(4, 1)`` meshes:

  * ``SingleServerPIR`` at ``PIR_SMOKE_LWE``'s shape (2^14 records of 32
    bytes): a bucket submitted before ``start()``, a publish of rows in
    every block, a bucket that reads them. The controller encrypts with
    the whole of A and each ``DISPATCH`` carries the ciphertexts; every
    rank builds the hint at ``start()`` and applies the publish's delta
    inside ``PUBLISH``: one build and one delta on every rank, two client
    fetches on the controller, as the reference counts them.
  * ``BatchPIR`` at ``PIR_SMOKE_BATCH``'s shape (2^10 records with
    checksums, m = 4, B = 8 buckets) with ``rounds=(4,)``: four rounds
    submitted before ``start()``, a publish, four more rounds and one that
    fails cuckoo placement, which raises on the controller before anything
    is enqueued. ``dispatch_log`` reads the reference's on every rank.

Records, epochs, bucket counts, counters and logs are integer data: equal
exactly.
"""
import json

import numpy as np
import pytest

from _torch_ranks import MESHES, run_ranks, session_vals

N_LWE = 1 << 14                      # PIR_SMOKE_LWE
Q = N_LWE // 4
LWE_FIRST = [3, 5000, 9000, 16000]
LWE_ROWS = [7, Q + 106, 2 * Q + 115, 3 * Q + 12]
LWE = {"kind": "session", "name": "lwe", "facade": "single",
       "protocol": "lwe-simple-1", "n_servers": 1, "n_items": N_LWE,
       "item_bytes": 32, "db_seed": 61, "key_seed": 62, "n_queries": 4,
       "max_wait_s": 60.0, "meshes": [list(m) for m in MESHES],
       "steps": [["submit", LWE_FIRST], ["start"], ["wait"],
                 ["publish", LWE_ROWS, 63], ["submit", LWE_ROWS], ["wait"],
                 ["close"]]}
N_BATCH = 1 << 10                    # PIR_SMOKE_BATCH
ROUNDS_1 = [[3, 300, 700, 1023], [9, 9, 40], [5], [511, 512, 513, 1000]]
BATCH_ROWS = [2, 300, 600, 1000]
#: 0, 222, 255 and 276 share the candidate buckets {1, 5, 7}
FAILS = [0, 222, 255, 276]
ROUNDS_2 = [BATCH_ROWS, [3, 4], [7, 8, 9], [1000]]
BATCH = {"kind": "session", "name": "batch", "facade": "batch",
         "protocol": "xor-dpf-2", "n_items": N_BATCH, "item_bytes": 32,
         "checksum": True, "batch_m": 4, "db_seed": 71, "key_seed": 72,
         "max_wait_s": 60.0, "meshes": [list(m) for m in MESHES],
         "rounds": [[4]] * len(MESHES),
         "steps": [["submit_batch", r] for r in ROUNDS_1]
         + [["start"], ["wait"], ["publish", BATCH_ROWS, 73],
            ["submit_batch", FAILS]]
         + [["submit_batch", r] for r in ROUNDS_2] + [["wait"], ["close"]]}
COMPARED = ("groups", "epochs", "bucket_counts", "batches", "lanes",
            "epoch")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("session", {"cases": [LWE, BATCH]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[LWE, BATCH])


def tag(name, mesh):
    return f"{name}/{mesh[0]}x{mesh[1]}"


def host_at(n, seed, rows, vals_seed, epoch):
    from repro_torch.core import pir
    db = pir.make_database(np.random.default_rng(seed), n, 32)
    if epoch:
        db[rows] = session_vals(32, rows, vals_seed)
    return db


@pytest.mark.parametrize("name", ["lwe", "batch"])
@pytest.mark.parametrize("mesh", MESHES)
def test_session_equals_the_references(runs, mesh, name):
    results, ref = runs
    want = json.loads(str(ref[tag(name, mesh)]))
    got = results[0][tag(name, mesh)]
    extra = {"lwe": ("hint_stats",),
             "batch": ("dispatch_log", "submit_errors")}[name]
    for key in COMPARED + extra:
        assert got[key] == want[key], key


@pytest.mark.parametrize("mesh", MESHES)
def test_lwe_records_are_the_host_rows_at_their_epoch(runs, mesh):
    first, second = runs[0][0][tag("lwe", mesh)]["groups"]
    for group, idx, epoch in ((first, LWE_FIRST, 0), (second, LWE_ROWS, 1)):
        want = host_at(N_LWE, 61, LWE_ROWS, 63, epoch)[idx].view(np.uint8)
        assert [o["epoch"] for o in group] == [epoch] * 4
        assert np.array_equal(np.asarray([o["record"] for o in group],
                                         np.uint8), want)


@pytest.mark.parametrize("mesh", MESHES)
def test_lwe_hint_is_built_once_and_delta_updated_on_every_rank(runs, mesh):
    results, ref = runs
    # builds, deltas, client fetches: the reference builds at its first
    # finalize and fetches once an epoch
    assert json.loads(str(ref[tag("lwe", mesh)]))["hint_stats"] == [1, 1, 2]
    for r, res in enumerate(results):
        assert res[tag("lwe", mesh)]["hint_stats"] == (
            [1, 1, 2] if r == 0 else [1, 1, 0])


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_records_are_the_host_rows_at_their_epoch(runs, mesh):
    first, second = runs[0][0][tag("batch", mesh)]["groups"]
    for group, rounds, epoch in ((first, ROUNDS_1, 0), (second, ROUNDS_2, 1)):
        host = host_at(N_BATCH, 71, BATCH_ROWS, 73, epoch)
        for o, idx in zip(group, rounds):
            assert o["epoch"] == epoch and o["error"] is None
            assert np.array_equal(np.asarray(o["record"], np.uint32),
                                  host[idx])


@pytest.mark.parametrize("mesh", MESHES)
def test_a_failed_placement_raises_on_the_controller_alone(runs, mesh):
    results, _ = runs
    (err,) = results[0][tag("batch", mesh)]["submit_errors"]
    assert err.startswith("CuckooFailure")
    # nothing was enqueued: two dispatches of four rounds, B wide
    for res in results:
        assert res[tag("batch", mesh)]["dispatch_log"] == [[4, 8], [4, 8]]


@pytest.mark.parametrize("name", ["lwe", "batch"])
@pytest.mark.parametrize("mesh", MESHES)
def test_followers_dispatch_and_publish_with_the_controller(runs, mesh,
                                                            name):
    results, _ = runs
    ctl = results[0][tag(name, mesh)]
    assert ctl["sent"] == {"DISPATCH": 2, "PUBLISH": 1, "STOP": 1}
    for res in results[1:]:
        f = res[tag(name, mesh)]["follower"]
        assert (f["dispatches"], f["publishes"], f["ended_by"]) == (
            ctl["batches"], 1, "STOP")
    assert {res[tag(name, mesh)]["epoch"] for res in results} == {1}
