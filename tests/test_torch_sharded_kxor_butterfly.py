"""The sharded ``PIRServer`` of xor-dpf-k (three parties): the butterfly
on the ``(1, 4)`` mesh and the gather on ``(4, 1)``, held against the
reference's sharded runs (``tests/_torch_ranks.py``) and the port's
answers without a mesh."""
import pytest

from _torch_ranks import PATHS, assert_answers, run_ranks, serve_case

BUTTERFLY = serve_case("k3b", "xor-dpf-k", [(1, 4)], ["butterfly"],
                       single=False)
GATHER_41 = serve_case("k3g41", "xor-dpf-k", [(4, 1)], ["gather"],
                       single=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("serve", {"cases": [BUTTERFLY, GATHER_41]},
                     tmp_path_factory.mktemp("ranks"),
                     ref_spec=[BUTTERFLY, GATHER_41])


@pytest.mark.parametrize("path", PATHS)
def test_butterfly_answers_equal_the_reference(runs, path):
    assert_answers(runs, BUTTERFLY, (1, 4), "butterfly", path)


@pytest.mark.parametrize("path", PATHS)
def test_gather_answers_on_one_shard_equal_the_reference(runs, path):
    assert_answers(runs, GATHER_41, (4, 1), "gather", path)
