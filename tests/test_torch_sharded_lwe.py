"""The single-server LWE scheme over a database sharded on a mesh, held
against the reference's 4-device run.

Four ``gloo`` ranks (``tests/_torch_ranks.py``) place ``PIR_SMOKE_LWE``'s
shape (2^14 records of 32 bytes) on the ``(1, 4)``, ``(2, 2)`` and
``(4, 1)`` meshes; the reference runs the same cases on four XLA CPU
devices (``tests/_ref_sharded.py``):

  * a ``Database`` with the LWE hint registered with its exact delta and
    without one: each rank builds its block's partial from its own rows of
    A and the partials are summed over the ``model`` group, so every rank
    holds the reference's replicated hint byte for byte, after the build
    and after each publish (an update over every block, then one that
    misses most blocks), with the reference's counters;
  * ``SingleServerPIR(mesh=)`` with the client rng seeded on rank 0 only:
    rank 0 encrypts and broadcasts, every rank decodes the reference's
    records at the reference's epochs, with its hint counters; in a
    session rank 0 serves a submit and the others refuse it by name.

All of it is integer math: equality is exact.
"""
import numpy as np
import pytest

from _torch_ranks import MESHES, run_ranks

N = 1 << 14                   # PIR_SMOKE_LWE
BLOCK = N // 4
#: an update with rows in every block of four, then one in block 1 only
UPDATES = [[[5, BLOCK + 200, 2 * BLOCK + 300, 3 * BLOCK + 400], 23],
           [[BLOCK + 7, BLOCK + 900], 24]]
BASE = {"protocol": "lwe-simple-1", "n_servers": 1, "n_items": N,
        "item_bytes": 32, "db_seed": 21, "meshes": [list(m) for m in MESHES],
        "updates": UPDATES}
HINT = {"kind": "hint", "name": "hint", **BASE}
SINGLE = {"kind": "single", "name": "lwe", **BASE, "key_seed": 22,
          "indices": [3, 17, 255, 1000], "n_queries": 4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("lwe", {"hint": HINT, "single": SINGLE},
                     tmp_path_factory.mktemp("ranks"),
                     ref_spec=[HINT, SINGLE])


@pytest.fixture(scope="module")
def states():
    """The host database after each publish, and its hint by the numpy
    oracle."""
    from repro_torch.core import lwe, pir
    db = pir.make_database(np.random.default_rng(BASE["db_seed"]), N, 32)
    params = lwe.params_for(N)
    out = []
    for step, upd in enumerate([None] + UPDATES):
        if upd is not None:
            db = db.copy()
            rows, seed = upd
            db[rows] = np.random.default_rng(seed).integers(
                0, 2 ** 32, size=(len(rows), 8),
                dtype=np.uint64).astype(np.uint32)
        out.append((db, lwe.hint_np(params, db.view(np.uint8)).astype(
            np.uint32)))
    return out


def tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("name", ["delta", "rebuilt"])
@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("mesh", MESHES)
def test_hint_equals_the_references_byte_for_byte(runs, states, mesh, step,
                                                  name):
    results, ref = runs
    want = u32(ref[f"hint/{tag(mesh)}/{name}{step}"])
    assert want.shape == (128, 32)
    assert np.array_equal(want, states[step][1])
    for res in results:
        assert np.array_equal(u32(res[f"hint/{tag(mesh)}/{name}{step}"]),
                              want)
        if step:
            assert res[f"hint/{tag(mesh)}/epoch{step}"] == int(
                ref[f"hint/{tag(mesh)}/epoch{step}"]) == step


@pytest.mark.parametrize("mesh", MESHES)
def test_hint_counters_equal_the_references(runs, mesh):
    results, ref = runs
    # two builds at epoch 0, one rebuild per publish of the delta-less
    # hint, one delta per publish on every rank (a block the delta misses
    # joins the sum with a zero partial)
    want = ref[f"hint/{tag(mesh)}/stats"].tolist()
    assert want == [4, 2]
    for res in results:
        assert res[f"hint/{tag(mesh)}/stats"] == want


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_draws_only_its_block_of_a(runs, mesh):
    m = mesh[1]
    for r, res in enumerate(runs[0]):
        s = r % m
        assert res[f"hint/{tag(mesh)}/a_rows"] == [
            (s * N // m, (s + 1) * N // m)]
        # the client's rank holds the whole of A (its block is a view)
        want = [(0, N)] if r == 0 else [tuple(res[f"lwe/{tag(mesh)}/rows"])]
        assert res[f"lwe/{tag(mesh)}/a_rows"] == want


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("mesh", MESHES)
def test_single_server_records_equal_the_references(runs, states, mesh,
                                                    step):
    results, ref = runs
    want = ref[f"lwe/{tag(mesh)}/q{step}"]
    idx = SINGLE["indices"] if step == 0 else \
        UPDATES[step - 1][0] + SINGLE["indices"]
    assert np.array_equal(want, states[step][0][idx].view(np.uint8))
    for res in results:
        got = res[f"lwe/{tag(mesh)}/q{step}"]
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert res[f"lwe/{tag(mesh)}/epoch{step}"] == int(
            ref[f"lwe/{tag(mesh)}/epoch{step}"]) == step


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("mesh", MESHES)
def test_single_server_hint_is_replicated(runs, mesh, step):
    results, ref = runs
    for res in results:
        assert np.array_equal(u32(res[f"lwe/{tag(mesh)}/hint{step}"]),
                              u32(ref[f"lwe/{tag(mesh)}/hint{step}"]))


@pytest.mark.parametrize("mesh", MESHES)
def test_single_server_counters_equal_the_references(runs, mesh):
    results, ref = runs
    # one build, one delta per publish, one client fetch per epoch
    want = ref[f"lwe/{tag(mesh)}/stats"].tolist()
    assert want == [1, 2, 3]
    for res in results:
        assert res[f"lwe/{tag(mesh)}/stats"] == want


@pytest.mark.parametrize("what,name", [("submit", "submit"),
                                       ("session", "a session")])
@pytest.mark.parametrize("mesh", MESHES)
def test_one_controller_paths_stay_refused(runs, states, mesh, what, name):
    # a session on every rank: rank 0, the controller, serves a submit and
    # the others refuse it by name; the session ends on every rank
    results, _ = runs
    for r, res in enumerate(results):
        if what == "submit" and r == 0:
            want = states[2][0][SINGLE["indices"][0]].view(np.uint8)
            assert np.array_equal(res[f"lwe/{tag(mesh)}/served/submit"], want)
        elif what == "submit":
            assert res[f"lwe/{tag(mesh)}/refused/submit"] == (
                "submit is the controller's on a mesh: call it on rank 0 "
                "(mesh.controller)")
        else:
            assert res[f"lwe/{tag(mesh)}/session"] == (
                "controller" if r == 0 else "STOP"), name


def test_a_hint_needs_the_model_group(runs):
    for res in runs[0]:
        msg = res["lwe/refused/no_group"]
        assert msg.startswith("a hint over a database sharded in 4 blocks")
        assert "'model' process group" in msg
