"""A fleet of single-server LWE replicas on sub-meshes of ranks behind one
controller, held against the reference's fleet on four XLA devices
(``lwe-simple-1``).

The script of ``tests/test_torch_sharded_fleet.py`` (a publish through the
router, a kill of r0 under load, a warm rejoin from r1's plans, a graceful
leave handed off to r1) on two ``(1, 2)`` and two ``(2, 1)`` sub-meshes of
four ``gloo`` ranks, at 2^10 records of 32 bytes. Rank 0, the fleet's
controller, is the client of every replica: it encrypts with the whole of
A. On r1's grid, which does not hold rank 0, the hint is built per row
block and summed at ``START`` and kept by the publish's delta, and the
client's cache misses ask the grid's first rank for it (``HINT``): the
hint counters (builds and deltas on every rank of a grid, client fetches
on the controller) equal the reference's per replica, as do the records,
epochs, suspects, failovers, resubmits, provenance and lanes.
"""
import json

import numpy as np
import pytest

from _torch_ranks import run_ranks, session_vals
from test_torch_sharded_fleet import (AXES, COMPARED, ENDED_BY, LABELS, N,
                                      ROWS, STEPS, submitted)

LWE = {"kind": "fleet", "name": "lwe", "protocol": "lwe-simple-1",
       "n_servers": 1, "n_items": N, "item_bytes": 32, "db_seed": 91,
       "router_seed": 92, "n_queries": 4, "buckets": [4],
       "max_wait_s": 60.0, "model_axes": AXES,
       "n_clusters": {"2": 1, "1": 2}, "steps": STEPS}
#: the ranks of each replica's grid
GRID = {"A": (0, 1), "B": (2, 3), "C": (0, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("fleet", {"cases": [LWE]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[LWE])


def tag(model_axis):
    return f"lwe/m{model_axis}"


@pytest.mark.parametrize("model_axis", AXES)
def test_lwe_fleet_equals_the_references(runs, model_axis):
    results, ref = runs
    want = json.loads(str(ref[tag(model_axis)]))
    got = results[0][tag(model_axis)]
    for key in COMPARED:
        assert got[key] == want[key], key
    for label in LABELS:
        for key in ("batches", "bucket_counts", "lanes", "reassignments"):
            assert got["stats"][label][key] == want["stats"][label][key], \
                (label, key)


def grid_counters(results, model_axis, label) -> list:
    """Each rank of a replica's grid: its database's hint builds and
    deltas (the controller's own, or what its follower record holds)."""
    out = []
    for rank in GRID[label]:
        res = results[rank][tag(model_axis)]
        if rank == 0:
            out.append(res["stats"][label]["hint_stats"][:2])
        else:
            (f,) = [f for f in res["followed"]
                    if f["serial"] == LABELS.index(label) + 1]
            out.append([f["n_hint_builds"], f["n_hint_deltas"]])
    return out


@pytest.mark.parametrize("model_axis", AXES)
def test_hint_counters_equal_the_references(runs, model_axis):
    results, ref = runs
    want = json.loads(str(ref[tag(model_axis)]))["stats"]
    ctl = results[0][tag(model_axis)]["stats"]
    for label in LABELS:
        builds_deltas, fetches = (want[label]["hint_stats"][:2],
                                  want[label]["hint_stats"][2])
        assert ctl[label]["hint_stats"][2] == fetches, label
        for counters in grid_counters(results, model_axis, label):
            assert counters == builds_deltas, label
    # one build at epoch 0 and one delta for the first two, one build at
    # epoch 1 for the rejoined replica (its catch-up found no hint)
    assert [want[label]["hint_stats"] for label in LABELS] == [
        [1, 1, 2], [1, 1, 2], [1, 0, 1]]
    # r1's client fetches went to its grid as HINT commands
    for rank in GRID["B"]:
        (f,) = results[rank][tag(model_axis)]["followed"]
        assert f["hints"] == fetches_of(ctl, "B")


def fetches_of(stats, label) -> int:
    return stats[label]["hint_stats"][2]


@pytest.mark.parametrize("model_axis", AXES)
def test_lwe_records_are_the_database_at_their_epoch(runs, model_axis):
    from repro_torch.core import pir
    host = pir.make_database(np.random.default_rng(LWE["db_seed"]), N, 32)
    after = host.copy()
    after[ROWS] = session_vals(32, ROWS, 21)
    got = runs[0][0][tag(model_axis)]
    for g, (group, idx) in enumerate(zip(got["groups"], submitted())):
        assert len(group) == len(idx)
        for o, i in zip(group, idx):
            assert o["error"] is None and o["epoch"] == min(g, 1)
            want = pir.db_as_bytes(after if o["epoch"] else host)[i]
            assert np.array_equal(np.asarray(o["record"], np.uint8), want)


@pytest.mark.parametrize("model_axis", AXES)
def test_lwe_followers_dispatch_the_controllers_batches(runs, model_axis):
    results, _ = runs
    ctl = results[0][tag(model_axis)]
    for rank in (1, 2, 3):
        for f in results[rank][tag(model_axis)]["followed"]:
            label = LABELS[f["serial"] - 1]
            assert rank in GRID[label]
            assert f["dispatches"] == ctl["stats"][label]["batches"]
            assert (f["ended_by"], f["exc"], f["epoch"]) == (
                ENDED_BY[label], None, 1)
