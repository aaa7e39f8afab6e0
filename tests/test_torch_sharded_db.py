"""The port's ``Database`` on a mesh against the reference's
``ShardedDatabase`` placement.

Four ``gloo`` ranks (``tests/_torch_ranks.py``) place one seeded database
on the ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` meshes; the reference places
it on the same mesh shapes of four XLA CPU devices
(``tests/_ref_sharded.py``). Each rank holds the row block of the
reference's device at its place in the grid, in every view (the ``bytes``
view a zero-copy alias of the words block); a staged delta over every
block, published on every rank, leaves each block equal to the
reference's rows after the same publish, and every rank at the same
epoch. ``sharding()`` describes the placement, and a hint registered on
the sharded database (the sum of the words, additive over the blocks) is
the reference's.
"""
import numpy as np
import pytest

from _torch_ranks import MESHES, N_ITEMS, run_ranks

SPEC = {"protocol": "xor-dpf-2", "n_items": N_ITEMS, "item_bytes": 32,
        "db_seed": 5, "meshes": [list(m) for m in MESHES],
        # every block of four gets rows, row 3 twice (the last write wins);
        # then rows in the first block only
        "updates": [[[3, 300, 600, 900, 1023, 3], 11], [[10, 20], 12]]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("db", SPEC, tmp_path_factory.mktemp("ranks"),
                     ref_spec=[{"kind": "placement", "name": "db", **SPEC}])


@pytest.fixture(scope="module")
def host():
    from repro_torch.core import pir
    return pir.make_database(np.random.default_rng(SPEC["db_seed"]), N_ITEMS,
                             32)


def tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


@pytest.mark.parametrize("view", ["words", "bytes"])
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_the_reference_devices_block(runs, host, mesh,
                                                     view):
    results, ref = runs
    t = tag(mesh)
    for r, res in enumerate(results):
        lo, hi = res[f"{t}/rows"]
        assert (lo, hi) == tuple(ref[f"db/{t}/{view}/rows"][r])
        assert hi - lo == N_ITEMS // mesh[1]
        want = host[lo:hi] if view == "words" else host[lo:hi].view(np.int8)
        assert np.array_equal(res[f"{t}/{view}"], want)


@pytest.mark.parametrize("mesh", MESHES)
def test_bytes_view_is_the_words_block_storage(runs, mesh):
    for res in runs[0]:
        assert res[f"{tag(mesh)}/bytes_alias"]
        assert res[f"{tag(mesh)}/resident_bytes"] == N_ITEMS // mesh[1] * 32


@pytest.mark.parametrize("mesh", MESHES)
def test_sharding_describes_the_placement(runs, mesh):
    d, m = mesh
    for r, res in enumerate(runs[0]):
        for view in ("words", "bytes"):
            got = res[f"{tag(mesh)}/sharding"][view]
            assert got == {"view": view, "axis": "model", "n_shards": m,
                           "shard": r % m, "rows": res[f"{tag(mesh)}/rows"],
                           "replicated_over": ("data",)}
        assert "nope" in res[f"{tag(mesh)}/sharding_unknown"]


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("mesh", MESHES)
def test_published_rows_reach_their_blocks(runs, host, mesh, step):
    results, ref = runs
    t = tag(mesh)
    want = ref[f"db/{t}/words{step}"]
    before = host if step == 0 else ref[f"db/{t}/words{step - 1}"]
    for res in results:
        lo, hi = res[f"{t}/rows"]
        assert res[f"{t}/epoch{step}"] == int(ref[f"db/{t}/epoch{step}"])
        assert np.array_equal(res[f"{t}/words{step}"], want[lo:hi])
        # the retired epoch still serves the rows before the publish
        assert np.array_equal(res[f"{t}/retired{step}"], before[lo:hi])


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_keeps_the_same_epoch_and_log(runs, mesh):
    t = tag(mesh)
    results = runs[0]
    for res in results:
        assert [res[f"{t}/epoch{s}"] for s in (0, 1)] == [1, 2]
        assert res[f"{t}/noop_epoch"] == 2            # nothing staged
        # the public delta is the whole one on every rank, deduplicated
        assert res[f"{t}/published"] == [(1, [300, 600, 900, 1023, 3], 6),
                                         (2, [10, 20], 2)]
        assert res[f"{t}/heard"] == [(1, [300, 600, 900, 1023, 3]),
                                     (2, [10, 20])]


@pytest.mark.parametrize("mesh", MESHES)
def test_hint_is_refused_on_a_sharded_database(runs, host, mesh):
    # no longer refused: each block's partial sum, summed over the blocks,
    # is the reference's sum of the words (uint32, wrapping) on every rank
    results, ref = runs
    want = int(ref[f"db/{tag(mesh)}/hint"])
    assert want == int(ref[f"db/{tag(mesh)}/words1"].sum(
        dtype=np.uint64) % 2 ** 32)
    for res in results:
        assert res[f"{tag(mesh)}/hint"] % 2 ** 32 == want


@pytest.mark.parametrize("mesh", MESHES)
def test_checksummed_blocks_match_the_reference(runs, mesh):
    results, ref = runs
    for res in results:
        lo, hi = res[f"{tag(mesh)}/rows"]
        want = ref[f"db/{tag(mesh)}/chk_words"][lo:hi]
        assert want.shape[1] == 9
        assert np.array_equal(res[f"{tag(mesh)}/chk_words"], want)


@pytest.mark.parametrize("mesh", MESHES)
def test_a_words_tensor_is_placed_by_block(runs, host, mesh):
    for res in runs[0]:
        lo, hi = res[f"{tag(mesh)}/rows"]
        assert np.array_equal(res[f"{tag(mesh)}/from_tensor"], host[lo:hi])
