"""The sharded ``PIRServer`` of xor-dpf-2 under the gather collective,
held against the reference's sharded run.

Four ``gloo`` ranks of the port (``tests/_torch_ranks.py``) serve one
seeded database over the ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` meshes, on
every path the port has on the CPU; the reference answers the same keys
with its ``PIRServer`` on the same mesh shapes of four XLA CPU devices and
on one device (``tests/_ref_sharded.py``). Every answer is equal bit for
bit. Also here: the one-device answers of additive-dpf-2 (its meshes are
in ``test_torch_sharded_add.py``), the rank's DB shard as its
``start_block``, the int32 reduce wrapping past 2^31, the bucket refusal,
and ``plan_report`` on a mesh against the reference's problem shape.
"""
import json

import numpy as np
import pytest

from _torch_ranks import (INDICES, MESHES, N_ITEMS, PATHS, assert_answers,
                          bits, run_ranks, serve_case)

CASE = serve_case("x2", "xor-dpf-2", MESHES, ["gather"])
ADD_ONE = serve_case("a2", "additive-dpf-2", [], ["gather"])
REPORT = {"kind": "report", "name": "rep", "protocol": "xor-dpf-2",
          "n_items": N_ITEMS, "item_bytes": 32,
          "meshes": [list(m) for m in MESHES], "buckets": [4, 8],
          "path": "baseline"}
#: per-rank int32 partials (columns: ranks) whose sums pass 2^31 either way
WRAP = [[2 ** 30] * 4, [2 ** 31 - 1, 1, 5, -7], [-2 ** 31, -2 ** 31, -1, -1],
        [2 ** 31 - 1] * 4]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("serve", {"cases": [CASE, ADD_ONE],
                               "reports": [REPORT], "wrap": WRAP,
                               "bucket_refusal": CASE},
                     tmp_path_factory.mktemp("ranks"),
                     ref_spec=[CASE, ADD_ONE, REPORT])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_answers_equal_the_reference(runs, mesh, path):
    assert_answers(runs, CASE, mesh, "gather", path)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", ["x2", "a2"])
def test_one_device_answers_equal_the_reference(runs, name, path):
    results, ref = runs
    for res in results:
        for p in (0, 1):
            assert np.array_equal(bits(res[f"{name}/single/{path}/p{p}"]),
                                  bits(ref[f"{name}/single/p{p}"]))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_answers_reconstruct_the_records(runs, mesh):
    from repro_torch.core import pir
    db = pir.make_database(np.random.default_rng(1), N_ITEMS, 32)
    d, m = mesh
    for res in runs[0]:
        rec = res[f"x2/{d}x{m}/gather/fused-cuda/p0"] \
            ^ res[f"x2/{d}x{m}/gather/fused-cuda/p1"]
        assert np.array_equal(rec, db[INDICES])


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_row_block(runs, mesh):
    d, m = mesh
    block = N_ITEMS // m
    for r, res in enumerate(runs[0]):
        assert res[f"x2/{d}x{m}/rows"] == ((r % m) * block,
                                           (r % m + 1) * block)


@pytest.mark.parametrize("protocol", ["additive-dpf-2", "lwe-simple-1"])
def test_sum_reduce_wraps_mod_2_32(runs, protocol):
    want = np.asarray(WRAP, np.int64).sum(axis=1) & 0xFFFFFFFF
    for res in runs[0]:
        got = res[f"wrap/{protocol}"][0]
        assert got.dtype == np.int32
        assert np.array_equal(got.view(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("what,want", [
    ("bucket", "ValueError: bucket 3 not divisible by 2 clusters"),
    ("other_mesh", "ValueError: database was placed on a different mesh"),
    ("no_mesh", "ValueError: database was placed on a different mesh"),
    # answer_views over a sharded database is served (the batch plane on
    # a mesh), no longer refused: its answers are checked below
    ("views", None)])
def test_sharded_serving_refusals(runs, what, want):
    for res in runs[0]:
        got = res[f"refused/{what}"]
        assert got is None if want is None else got.startswith(want)


@pytest.mark.parametrize("mesh", MESHES)
def test_answer_views_on_a_mesh_equals_one_device(runs, mesh):
    # two views of the rank's block, two queries each: one reduce for both
    # views, the answers those of the whole database on one device
    d, m = mesh
    for res in runs[0]:
        got = res[f"views/{d}x{m}"]
        want = res["x2/single/baseline/p0"].reshape(2, 2, -1)
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_plan_report_is_one_shard_at_bucket_over_clusters(runs, mesh):
    from repro.config import PIRConfig as RefPIRConfig
    from repro.engine.tuner import problem_shape as ref_problem_shape
    from repro_torch import engine
    from repro_torch.config import PIRConfig
    from repro_torch.core.protocol import resolve_plan
    from repro_torch.engine.tuner import problem_shape
    d, m = mesh
    results, ref = runs
    want = json.loads(str(ref[f"rep/{d}x{m}"]))
    cfg = PIRConfig(n_items=N_ITEMS, item_bytes=32)
    for res in results:
        rows = res[f"rep/{d}x{m}"]
        assert sorted(rows) == sorted(int(b) for b in want)
        for b, row in rows.items():
            assert row["provenance"] == want[str(b)]["provenance"]
            assert row["plan"] == want[str(b)]["plan"].replace("jnp",
                                                               "torch")
            # the same problem as the reference's: b / C queries against
            # one shard of N / P rows
            shape = problem_shape(cfg, b // d, n_shards=m)
            ref_shape = ref_problem_shape(RefPIRConfig(n_items=N_ITEMS),
                                          b // d, n_shards=m)
            assert (shape.bucket, shape.rows, shape.item_bytes) == (
                ref_shape.bucket, ref_shape.rows, ref_shape.item_bytes)
            plan = resolve_plan("baseline", cfg, b, backend="cpu")
            assert row == {k: v for k, v in engine.plan_report(
                cfg, plan, b // d, n_shards=m, backend="cpu").items()
                if k in row}
