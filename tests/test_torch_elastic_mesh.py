"""``carve_submeshes`` and ``rebuild_mesh`` over four ``gloo`` ranks, held
against the reference's on four XLA devices.

Each rank of ``tests/_torch_ranks.py`` carves ``n`` replicas' sub-meshes
for model axes 1, 2 and 4 and one or two pods, and rebuilds a mesh from
subsets of the live ranks; the reference (``tests/_ref_sharded.py``) does
the same on its devices. Where the reference's grids are disjoint, the
port's have the same shape, axes and ranks in the devices' order; every
carved mesh is controlled by rank 0 (inside its grid or outside it) and
shares one ``Fleet``, a rebuilt one by its first rank. Groups the
reference lets overlap over several devices raise in the port, and a
plan the live set cannot hold raises in both.
"""
import json

import pytest

from _torch_ranks import run_ranks

CARVES = [[n, m, p] for n in (1, 2, 4) for m in (1, 2, 4) for p in (1, 2)]
REBUILDS = [[live, m, p] for live in ([0, 1, 2, 3], [1, 2, 3], [2, 3])
            for m in (1, 2) for p in (1, 2)]
SPEC = {"kind": "elastic", "name": "elastic", "carves": CARVES,
        "rebuilds": REBUILDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    results, ref = run_ranks("elastic", SPEC,
                             tmp_path_factory.mktemp("ranks"),
                             ref_spec=[SPEC])
    return results, json.loads(str(ref["elastic"]))


def overlap(meshes) -> bool:
    ids = [i for m in meshes for i in m["ids"]]
    return len(set(ids)) < len(ids) and max(len(m["ids"])
                                            for m in meshes) > 1


@pytest.mark.parametrize("n,model_axis,pods", CARVES)
def test_carve_submeshes_gives_the_references_grids(runs, n, model_axis,
                                                    pods):
    results, ref = runs
    key = f"carve/{n}/{model_axis}/{pods}"
    want = ref[key]
    for rank, res in enumerate(results):
        got = res[key]
        if isinstance(want, str):           # the plan needs more devices
            assert got.startswith("ValueError")
            continue
        if overlap(want):
            assert got.startswith("ValueError") and "overlap" in got
            continue
        assert [{k: g[k] for k in ("shape", "axes", "ids")} for g in got] \
            == want
        for i, g in enumerate(got):
            assert g["controller"] == 0 and g["fleet"] == [0, i]
            assert g["contains_rank"] == (rank in g["ids"])
            assert (g["coords"] is None) == (rank not in g["ids"])


@pytest.mark.parametrize("live,model_axis,pods", REBUILDS)
def test_rebuild_mesh_gives_the_references_grid(runs, live, model_axis,
                                                pods):
    results, ref = runs
    key = f"rebuild/{','.join(map(str, live))}/{model_axis}/{pods}"
    want = ref[key]
    for rank, res in enumerate(results):
        got = res[key]
        if isinstance(want, str):
            assert got.startswith("ValueError")
            continue
        assert {k: got[k] for k in ("shape", "axes", "ids")} == want
        assert got["controller"] == want["ids"][0] and got["fleet"] is None
        assert got["contains_rank"] == (rank in want["ids"])


def test_coordinates_are_row_major_over_the_ranks(runs):
    # two (2, 1) replicas over ranks {0, 1} and {2, 3}: each rank is a
    # cluster (data) of its own replica's grid
    results, _ = runs
    for rank, res in enumerate(results):
        meshes = res["carve/2/1/1"]
        mine = meshes[rank // 2]
        assert mine["shape"] == {"data": 2, "model": 1}
        assert mine["coords"] == {"data": rank % 2, "model": 0}
        assert meshes[1 - rank // 2]["coords"] is None
