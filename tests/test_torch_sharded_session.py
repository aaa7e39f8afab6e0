"""Streaming sessions over a database sharded on a mesh, through one
controller rank, held against the reference's 4-device sessions.

Four ``gloo`` ranks (``tests/_torch_ranks.py``) build ``MultiServerPIR`` at
``PIR_SMOKE``'s shape (2^14 records of 32 bytes) on each mesh; rank 0 is
the controller: it submits, cuts the batches and sends each one to the
followers, which stage and dispatch it themselves. The reference runs the
same script on four XLA CPU devices (``tests/_ref_sharded.py``), its one
controller driving every device. Both play ``_torch_ranks.play_session``:
a whole bucket submitted before ``start()`` (so that the cuts do not
depend on timing), a publish of rows in every block between two batches,
a second bucket that reads them, ``close()``. With ``n_clusters=2`` the
two batches go to the two lanes. Everything compared is integer data:
records, the epoch each future is tagged with, the published epochs, the
bucket counts, the lanes. Port-only: every follower's client call during a
session raises a ``ValueError`` naming the controller, and a publish from a
client thread while four client threads submit lands between two
dispatches on every rank. Without process groups (a ``Mesh`` of four ranks
seen from one): a follower refuses the streaming submits outside a session
too, and an SPMD ``query`` refuses while the controller holds submitted
queries, before any collective.
"""
import numpy as np
import pytest

from _torch_ranks import MESHES, run_ranks, session_vals

N = 1 << 14                          # PIR_SMOKE
BLOCK = N // 4
#: one bucket before start(), rows in every block of four, then a bucket
#: that reads two of them
FIRST = [3, BLOCK + 904, 2 * BLOCK + 808, 4 * BLOCK - 1]
ROWS = [7, BLOCK + 106, 2 * BLOCK + 115, 3 * BLOCK + 12]
SECOND = [ROWS[0], ROWS[2], 100, 3 * BLOCK + 5]
STEPS = [["submit", FIRST], ["start"], ["wait"], ["publish", ROWS, 43],
         ["submit", SECOND], ["wait"], ["close"]]
BASE = {"kind": "session", "facade": "multi", "n_items": N,
        "item_bytes": 32, "db_seed": 41, "key_seed": 42, "n_queries": 4,
        "max_wait_s": 60.0, "n_clusters": 2, "steps": STEPS}
XOR = {**BASE, "name": "xor", "protocol": "xor-dpf-2",
       "meshes": [list(m) for m in MESHES]}
ADD = {**BASE, "name": "add", "protocol": "additive-dpf-2",
       "meshes": [[2, 2]]}
#: port-only: the followers' refusals, then 36 queries (the published
#: rows among them) from four client threads and a publish from a fifth
RACE_IDX = sorted(list(range(0, N, 512)) + ROWS)
RACE = {**BASE, "name": "race", "protocol": "xor-dpf-2", "n_clusters": 1,
        "max_wait_s": 0.005, "meshes": [[2, 2]],
        "steps": [["start"], ["refusals"], ["race", RACE_IDX, ROWS, 44],
                  ["close"]]}
CASES = [("xor", m) for m in MESHES] + [("add", (2, 2))]
COMPARED = ("groups", "epochs", "bucket_counts", "batches", "lanes",
            "fired", "epoch")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("session", {"cases": [XOR, ADD, RACE]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[XOR, ADD])


def tag(name, mesh):
    return f"{name}/{mesh[0]}x{mesh[1]}"


def host_at(epoch: int, seed: int = 43) -> np.ndarray:
    from repro_torch.core import pir
    db = pir.make_database(np.random.default_rng(BASE["db_seed"]), N, 32)
    if epoch:
        db[ROWS] = session_vals(32, ROWS, seed)
    return db


def records(words, name):
    return words.view(np.uint8) if name == "add" else words


@pytest.mark.parametrize("name,mesh", CASES)
def test_session_equals_the_references(runs, name, mesh):
    import json
    results, ref = runs
    want = json.loads(str(ref[tag(name, mesh)]))
    got = results[0][tag(name, mesh)]
    for key in COMPARED:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name,mesh", CASES)
def test_records_are_the_host_rows_at_their_epoch(runs, name, mesh):
    first, second = runs[0][0][tag(name, mesh)]["groups"]
    for group, idx, epoch in ((first, FIRST, 0), (second, SECOND, 1)):
        want = records(host_at(epoch)[idx], name)
        assert [o["epoch"] for o in group] == [epoch] * 4
        assert np.array_equal(np.asarray([o["record"] for o in group],
                                         want.dtype), want)


@pytest.mark.parametrize("name,mesh", CASES)
def test_both_lanes_serve_one_bucket_each(runs, name, mesh):
    res = runs[0][0][tag(name, mesh)]
    assert res["lanes"] == ["cluster0", "cluster1"]
    assert res["bucket_counts"] == {"4": 2} and res["epochs"] == [1]
    assert res["sent"] == {"DISPATCH": 2, "PUBLISH": 1, "STOP": 1}


@pytest.mark.parametrize("name,mesh", CASES)
def test_followers_dispatch_what_the_controller_cut(runs, name, mesh):
    results = runs[0]
    batches = results[0][tag(name, mesh)]["batches"]
    for res in results[1:]:
        f = res[tag(name, mesh)]["follower"]
        assert (f["dispatches"], f["publishes"], f["ended_by"],
                f["exc"]) == (batches, 1, "STOP", None)
        assert res[tag(name, mesh)]["batches"] == 0     # no cut of its own
    # after close() every rank stands at the controller's epoch
    assert {res[tag(name, mesh)]["epoch"] for res in results} == {1}


@pytest.mark.parametrize("what", ["submit", "update", "publish", "query",
                                  "queue_depth", "drain_handoff", "kill"])
def test_follower_client_calls_name_the_controller(runs, what):
    for res in runs[0][1:]:
        msg = res[tag("race", (2, 2))]["refused"][what]
        assert msg == (f"{what} is the controller's on a mesh: call it on "
                       f"rank 0 (mesh.controller)")


def test_a_client_threads_publish_lands_between_dispatches(runs):
    results = runs[0]
    race = results[0][tag("race", (2, 2))]["race"]
    assert race["published"] == [1]
    outcomes = race["outcomes"]
    assert sorted(o["index"] for o in outcomes) == RACE_IDX
    hosts = [host_at(0), host_at(1, seed=44)]
    for o in outcomes:
        # each record is the host row at the epoch its batch was tagged with
        assert o["error"] is None and o["epoch"] in (0, 1)
        assert np.array_equal(np.asarray(o["record"], np.uint32),
                              hosts[o["epoch"]][o["index"]])
    batches = results[0][tag("race", (2, 2))]["batches"]
    for res in results:
        assert res[tag("race", (2, 2))]["epoch"] == 1
    for res in results[1:]:
        f = res[tag("race", (2, 2))]["follower"]
        assert (f["dispatches"], f["publishes"], f["ended_by"]) == (
            batches, 1, "STOP")


def _bare(rank):
    import torch
    from repro_torch.launch.mesh import Mesh
    return Mesh(axis_names=("data", "model"), sizes=(1, 4),
                ranks=(0, 1, 2, 3), rank=rank, device=torch.device("cpu"))


@pytest.mark.parametrize("call", ["submit", "query_after_submit"])
def test_streaming_submits_are_the_controllers_outside_a_session(call):
    from repro_torch.configs.pir import PIR_SMOKE
    from repro_torch.runtime.serve_loop import TwoServerPIR
    db = host_at(0)
    if call == "submit":
        follower = TwoServerPIR(db, PIR_SMOKE, mesh=_bare(2))
        with pytest.raises(ValueError, match=r"^submit is the controller's "
                           r"on a mesh: call it on rank 0"):
            follower.submit(3)
        return
    ctl = TwoServerPIR(db, PIR_SMOKE, mesh=_bare(0),
                       client_rng=np.random.default_rng(0))
    ctl.submit(3)                      # waits for a session
    with pytest.raises(ValueError, match=r"^queries submitted on this mesh "
                       r"wait for a session \(1\)"):
        ctl.query([1])
