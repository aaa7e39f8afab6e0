"""The batch plane over a bucketed database sharded on a mesh, held against
the reference's 4-device run.

Four ``gloo`` ranks (``tests/_torch_ranks.py``) build ``BatchPIR(mesh=)``
at ``PIR_SMOKE_BATCH``'s shape (2^10 records of 32 bytes with checksums,
m = 4, B = 8 buckets of 512 rows) on the ``(1, 4)`` and ``(2, 2)`` meshes
with ``rounds=(2,)`` and on ``(4, 1)`` with ``rounds=(4,)``; the reference
runs the same cases on four XLA CPU devices (``tests/_ref_sharded.py``).
The client rng is seeded on rank 0 only: rounds are planned there and
broadcast, a failed cuckoo placement included, so every rank takes the
same halving. Every rank returns the reference's records before and after
a published update over every block, at the same epoch, with the
reference's ``dispatch_log``; each party's dispatch makes one reduce over
the shard axis for all B buckets. The reference's refusals of buckets
that do not divide over the clusters are the port's, and an additive
deployment serves on ``(1, 4)``.
"""
import numpy as np
import pytest

from _torch_ranks import run_ranks

N = 1 << 10
#: 0, 222, 255 and 276 share the candidate buckets {1, 5, 7}: four indices
#: in three buckets cannot all place, so query_batch halves that batch
FAILS = [0, 222, 255, 276]
QUERIES = [[3, 300, 700, 1023], FAILS, [9, 9, 40]]
BASE = {"n_items": N, "item_bytes": 32, "batch_m": 4, "checksum": True,
        "db_seed": 31, "key_seed": 32, "queries": QUERIES,
        # rows in each quarter of the records
        "update_rows": [2, 300, 600, 1000], "update_seed": 33}
XOR = {"kind": "batch", "name": "x2", "protocol": "xor-dpf-2", **BASE,
       "meshes": [[[1, 4], [2]], [[2, 2], [2]], [[4, 1], [4]]],
       "refusals": [[[2, 2], [1]], [[4, 1], [2]]], "lanes": True}
ADD = {"kind": "batch", "name": "a2", "protocol": "additive-dpf-2", **BASE,
       "meshes": [[[1, 4], [2]]]}
MESHES = [(1, 4), (2, 2), (4, 1)]
CASES = [("x2", m) for m in MESHES] + [("a2", (1, 4))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("batch", {"cases": [XOR, ADD]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[XOR, ADD])


@pytest.fixture(scope="module")
def host():
    from repro_torch.core import pir
    db = pir.make_database(np.random.default_rng(BASE["db_seed"]), N, 32)
    upd = np.random.default_rng(BASE["update_seed"]).integers(
        0, 2 ** 32, size=(len(BASE["update_rows"]), 8),
        dtype=np.uint64).astype(np.uint32)
    return db, upd


def tag(name, mesh):
    return f"{name}/{mesh[0]}x{mesh[1]}"


def records(words, name):
    return words.view(np.uint8) if name == "a2" else words


@pytest.mark.parametrize("step", range(len(QUERIES)))
@pytest.mark.parametrize("name,mesh", CASES)
def test_records_equal_the_references(runs, host, name, mesh, step):
    results, ref = runs
    want = ref[f"{tag(name, mesh)}/q{step}"]
    assert np.array_equal(want, records(host[0][QUERIES[step]], name))
    for res in results:
        assert np.array_equal(res[f"{tag(name, mesh)}/q{step}"], want)


@pytest.mark.parametrize("name,mesh", CASES)
def test_a_published_update_is_served(runs, host, name, mesh):
    results, ref = runs
    t = tag(name, mesh)
    want = ref[f"{t}/q_after"]
    assert np.array_equal(want, records(host[1], name))
    for res in results:
        assert res[f"{t}/epoch"] == int(ref[f"{t}/epoch"]) == 1
        assert np.array_equal(res[f"{t}/q_after"], want)


@pytest.mark.parametrize("name,mesh", CASES)
def test_dispatch_log_equals_the_references(runs, name, mesh):
    results, ref = runs
    want = [tuple(r) for r in ref[f"{tag(name, mesh)}/dispatch_log"].tolist()]
    # one dispatch a batch, the failed one's two halves together; B wide
    assert want == [(1, 8), (2, 8), (1, 8), (1, 8)]
    for res in results:
        assert res[f"{tag(name, mesh)}/dispatch_log"] == want


@pytest.mark.parametrize("name,mesh", CASES)
def test_rounds_are_planned_on_the_first_rank_only(runs, name, mesh):
    # four batches, the failed one planned three times (it, then its
    # halves): every other rank receives the plans, the failure included
    for r, res in enumerate(runs[0]):
        assert res[f"{tag(name, mesh)}/calls/plan_round"] == (
            6 if r == 0 else 0)


@pytest.mark.parametrize("name,mesh", CASES)
def test_one_reduce_a_party_and_dispatch(runs, name, mesh):
    d, m = mesh
    for res in runs[0]:
        n = 2 * len(res[f"{tag(name, mesh)}/dispatch_log"])
        assert res[f"{tag(name, mesh)}/calls/combine"] == n
        # no shard axis to reduce over on (4, 1)
        assert res[f"{tag(name, mesh)}/calls/reduce"] == (n if m > 1 else 0)


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_block_of_every_bucket(runs, mesh):
    d, m = mesh
    for r, res in enumerate(runs[0]):
        s = r % m
        assert res[f"{tag('x2', mesh)}/rows"] == (s * 512 // m,
                                                  (s + 1) * 512 // m)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_buckets_that_do_not_divide_are_refused_as_the_reference(runs,
                                                                 mesh):
    results, ref = runs
    want = str(ref[f"x2/refused/{mesh[0]}x{mesh[1]}"])
    rounds = {(2, 2): 1, (4, 1): 2}[mesh]
    assert want == (f"ValueError: bucket {rounds} not divisible by "
                    f"{mesh[0]} clusters")
    for res in results:
        assert res[f"x2/refused/{mesh[0]}x{mesh[1]}"] == want


@pytest.mark.parametrize("name,mesh", CASES)
def test_sessions_and_lanes_stay_refused(runs, name, mesh):
    for res in runs[0]:
        msg = res[f"{tag(name, mesh)}/refused/submit"]
        assert msg.startswith("submit") and "A6b-serve-2" in msg
        lanes = res["x2/refused/lanes"]
        assert lanes.startswith("n_clusters lanes") and "A6b-serve-2" in lanes
