"""The sharded ``PIRServer`` of xor-dpf-k (three parties) under the gather
collective on the ``(1, 4)`` mesh, held against the reference's sharded
and one-device runs (``tests/_torch_ranks.py``). Its other meshes and the
butterfly are in ``test_torch_sharded_kxor_2x2.py``,
``test_torch_sharded_kxor_butterfly.py`` and
``test_torch_sharded_butterfly.py`` (one file each keeps the reference's
compiles of three parties' steps under half a minute).
"""
import numpy as np
import pytest

from _torch_ranks import (INDICES, N_ITEMS, PATHS, assert_answers, run_ranks,
                          serve_case)

CASE = serve_case("k3", "xor-dpf-k", [(1, 4)], ["gather"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("serve", {"cases": [CASE]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[CASE])


@pytest.mark.parametrize("path", PATHS)
def test_answers_equal_the_reference(runs, path):
    assert_answers(runs, CASE, (1, 4), "gather", path)


@pytest.mark.parametrize("path", PATHS)
def test_three_shares_reconstruct_the_records(runs, path):
    from repro_torch.core import pir
    db = pir.make_database(np.random.default_rng(1), N_ITEMS, 32)
    for res in runs[0]:
        rec = res[f"k3/1x4/gather/{path}/p0"] \
            ^ res[f"k3/1x4/gather/{path}/p1"] \
            ^ res[f"k3/1x4/gather/{path}/p2"]
        assert np.array_equal(rec, db[INDICES])
