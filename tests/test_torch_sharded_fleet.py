"""A fleet of replicas on sub-meshes of ranks behind one controller, held
against the reference's fleet on four XLA devices (``xor-dpf-2``).

Four ``gloo`` ranks (``tests/_torch_ranks.py``) carve two sub-meshes with
``carve_submeshes(2, model_axis=2)``: two ``(1, 2)`` meshes over ranks
{0, 1} and {2, 3} (``tests/test_torch_sharded_fleet_lanes.py`` runs the
same checks on the two ``(2, 1)`` meshes, two lanes each, of a model axis
of 1). Rank 0 is the fleet's controller: it runs the ``Router`` and
every replica's host half, inside r0's grid and outside r1's, whose first
rank sends each batch's answer back. Ranks 1-3 follow the fleet
(``replica.follow_fleet``). The reference (``tests/_ref_sharded.py``)
plays the same script (``_torch_ranks.play_fleet``) on its sub-meshes of
four devices, at 2^10 records of 32 bytes, whole buckets of four and a
minute's ``max_wait_s`` (batches are cut when full, never by timing):

  1. a bucket to each replica at epoch 0, a publish through the router, a
     bucket to each at epoch 1;
  2. a kill of r0 with two queries pending: both fail over to r1;
  3. a warm rejoin of r0 on ``meshes[0]`` from r1's ``export_plans()``;
  4. a graceful leave of the rejoined r0 with two queries pending, handed
     off to r1.

Records, epoch tags, the replica that answered, the replicas' epochs,
suspects, failovers, resubmits, plan provenance and each replica's
batches, buckets and lanes are integer data: equal exactly. Each
follower dispatched its controller's batches, the killed replica's
followers left by ``ABORT`` and the others' by ``STOP``.
"""
import json

import numpy as np
import pytest

from _torch_ranks import run_ranks, session_vals

N = 1 << 10
ROWS = [5, 513, 1000]
STEPS = [["attach", "A", "r0", 0, 11, None],
         ["attach", "B", "r1", 1, 12, None],
         ["submit", "r0", [5, 300, 700, 1023]],
         ["submit", "r1", [1, 2, 513, 1000]], ["wait"],
         ["publish", ROWS, 21],
         ["submit", "r0", [5, 6, 7, 8]],
         ["submit", "r1", [513, 9, 10, 11]], ["wait"],
         ["submit", "r0", [1000, 12]], ["kill", "r0"],
         ["submit", "r1", [13, 14]], ["wait"],
         ["detach", "r0"],
         ["attach", "C", "r0", 0, 13, "B"],
         ["submit", "r0", [0, 1, 2, 3]], ["wait"],
         ["submit", "r0", [513, 5]], ["detach", "r0"],
         ["submit", "r1", [20, 21]], ["wait"],
         ["close"]]
XOR = {"kind": "fleet", "name": "xor", "protocol": "xor-dpf-2",
       "n_items": N, "item_bytes": 32, "db_seed": 81, "router_seed": 82,
       "n_queries": 4, "buckets": [4], "max_wait_s": 60.0,
       "model_axes": [2], "n_clusters": {"2": 1, "1": 2},
       "steps": STEPS}
#: model axes: 2 here, 1 in ``test_torch_sharded_fleet_lanes.py``, both
#: in the LWE file
AXES = [2, 1]
#: the replicas in attach order (their fleet serials 1, 2, 3) and how
#: each one's session ends on its followers
LABELS = ("A", "B", "C")
ENDED_BY = {"A": "ABORT", "B": "STOP", "C": "STOP"}
COMPARED = ("groups", "epochs", "provenance", "suspects", "handed_off",
            "final_epochs", "failovers", "resubmitted",
            "integrity_failures")


def fleet_runs(tmp_path_factory, model_axis: int):
    """The ranks' and the reference's runs of the xor fleet on one model
    axis."""
    case = dict(XOR, model_axes=[model_axis])
    return run_ranks("fleet", {"cases": [case]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[case])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fleet_runs(tmp_path_factory, 2)


def tag(model_axis):
    return f"xor/m{model_axis}"


def check_fleet_equals_the_references(runs, model_axis):
    results, ref = runs
    want = json.loads(str(ref[tag(model_axis)]))
    got = results[0][tag(model_axis)]
    for key in COMPARED:
        assert got[key] == want[key], key
    for label in LABELS:
        for key in ("batches", "bucket_counts", "lanes", "reassignments"):
            assert got["stats"][label][key] == want["stats"][label][key], \
                (label, key)


def submitted() -> list:
    """The indices of each group of futures the script waits for."""
    groups, cur = [], []
    for step in STEPS:
        if step[0] == "submit":
            cur += step[2]
        elif step[0] == "wait":
            groups, cur = groups + [cur], []
    return groups


def check_records_are_the_database_at_their_epoch(runs, model_axis):
    from repro_torch.core import pir
    host = pir.make_database(np.random.default_rng(XOR["db_seed"]), N, 32)
    after = host.copy()
    after[ROWS] = session_vals(32, ROWS, 21)
    got = runs[0][0][tag(model_axis)]
    groups = submitted()
    assert [len(g) for g in got["groups"]] == [len(g) for g in groups]
    for g, (group, idx) in enumerate(zip(got["groups"], groups)):
        for o, i in zip(group, idx):
            assert o["error"] is None and o["epoch"] == min(g, 1)
            want = (after if o["epoch"] else host)[i]
            assert np.array_equal(np.asarray(o["record"], np.uint32), want)


def check_the_sub_meshes_are_the_references(runs, model_axis):
    results, ref = runs
    want = json.loads(str(ref[tag(model_axis)]))["meshes"]
    got = results[0][tag(model_axis)]["meshes"]
    shape = [1, 2] if model_axis == 2 else [2, 1]
    assert [m[:2] for m in got] == want == [[shape, [0, 1]], [shape, [2, 3]]]
    # rank 0 controls both: inside r0's grid, outside r1's
    assert [m[2] for m in got] == [0, 0]
    assert results[0][tag(model_axis)]["remote"] == {"0": False, "1": True}


def check_followers_dispatch_the_controllers_batches(runs, model_axis):
    results, _ = runs
    ctl = results[0][tag(model_axis)]
    held = {1: ["A", "C"], 2: ["B"], 3: ["B"]}
    for rank in (1, 2, 3):
        followed = results[rank][tag(model_axis)]["followed"]
        assert [f["serial"] for f in followed] == [
            LABELS.index(label) + 1 for label in held[rank]]
        for f in followed:
            label = LABELS[f["serial"] - 1]
            assert f["id"] == ("r1" if label == "B" else "r0")
            assert f["dispatches"] == ctl["stats"][label]["batches"]
            assert (f["ended_by"], f["exc"], f["starts"]) == (
                ENDED_BY[label], None, 1)
            # the publish in session, and the rejoin's catch-up before it
            assert (f["publishes"], f["epoch"]) == (1, 1)
            assert f["hints"] == 0


def check_close_returns_on_every_rank(runs, model_axis):
    ends = [r[tag(model_axis)]["t_done"] for r in runs[0]]
    assert max(ends) - min(ends) < 10.0


CHECKS = {name[len("check_"):]: fn for name, fn in list(globals().items())
          if name.startswith("check_")}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_fleet_on_1x2_sub_meshes(runs, check):
    CHECKS[check](runs, 2)
