"""``TwoServerPIR`` and ``MultiServerPIR`` over four ``gloo`` ranks.

Every rank (``tests/_torch_ranks.py``) builds the facade on a ``(1, 4)``
and a ``(2, 2)`` mesh and calls ``query``, ``update`` and ``publish`` with
the same arguments; only rank 0's client rng is seeded, so the records
come out right only because rank 0's keys are broadcast. Every rank gets
the host rows, before and after an update whose rows span all four
blocks, at the same epoch. ``SingleServerPIR`` serves on a mesh too. What
needs one controller (a session, ``submit``, lanes, chaos) rank 0 serves
in a session, and every other rank refuses by name.
"""
import numpy as np
import pytest

from _torch_ranks import N_ITEMS, run_ranks

SPEC = {"protocol": "xor-dpf-2", "n_items": N_ITEMS, "item_bytes": 32,
        "db_seed": 5, "key_seed": 9, "meshes": [[1, 4], [2, 2]],
        # two rows in each block of four
        "indices": [1, 255, 256, 511, 512, 767, 768, 1023],
        "update_rows": [2, 300, 600, 1000, 7, 259, 513, 999],
        "update_seed": 13}
PROTOCOLS = ["xor-dpf-2", "additive-dpf-2", "xor-dpf-k"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("facade", SPEC, tmp_path_factory.mktemp("ranks"))[0]


@pytest.fixture(scope="module")
def rows():
    from repro_torch.core import pir
    host = pir.make_database(np.random.default_rng(SPEC["db_seed"]),
                             N_ITEMS, 32)
    upd = np.random.default_rng(SPEC["update_seed"]).integers(
        0, 2 ** 32, size=(len(SPEC["update_rows"]), 8),
        dtype=np.uint64).astype(np.uint32)
    return host, upd


def as_records(words: np.ndarray, protocol: str) -> np.ndarray:
    return words.view(np.uint8) if protocol == "additive-dpf-2" else words


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_query_returns_the_host_rows(runs, rows, mesh, protocol):
    host, _ = rows
    idx = SPEC["indices"]
    for res in runs:
        assert np.array_equal(res[f"{mesh}/{protocol}/q0"],
                              as_records(host[idx], protocol))
        assert np.array_equal(res[f"{mesh}/{protocol}/q1"],
                              as_records(host[idx[:3]], protocol))


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_an_update_over_every_block_is_served(runs, rows, mesh, protocol):
    host, upd = rows
    for res in runs:
        assert res[f"{mesh}/{protocol}/epoch"] == 1
        assert np.array_equal(res[f"{mesh}/{protocol}/q2"],
                              as_records(upd, protocol))
        assert np.array_equal(res[f"{mesh}/{protocol}/q3"],
                              as_records(host[SPEC["indices"]], protocol))


@pytest.mark.parametrize("what,name", [
    ("session", "query"), ("submit", "submit"),
    ("lanes", "submit"), ("chaos", "submit"), ("single", "submit")])
def test_one_controller_paths_are_refused_on_a_mesh(runs, rows, what, name):
    # a session, submit, lanes, chaos and SingleServerPIR's submit on the
    # (2, 2) mesh: rank 0, the controller, serves them; every other rank
    # refuses the client call and names the controller
    host, _ = rows
    want = host[SPEC["indices"][:4]]
    assert np.array_equal(runs[0][f"served/{what}"],
                          want.view(np.uint8) if what == "single" else want)
    for res in runs[1:]:
        assert res[f"refused/{what}"] == (
            f"{name} is the controller's on a mesh: call it on rank 0 "
            f"(mesh.controller)")
    # only the controller visits the chaos seams
    assert [res["chaos_visits"] > 0 for res in runs] == [True] + [False] * 3


def test_single_server_serves_on_a_mesh(runs, rows):
    # lwe-simple-1 on the (2, 2) mesh: rank 0 encrypts, every rank decodes
    host, _ = rows
    for res in runs:
        assert np.array_equal(res["single/q0"],
                              host[SPEC["indices"]].view(np.uint8))
