"""The sharded ``PIRServer`` of xor-dpf-k (three parties) on the ``(2, 2)``
mesh, under the gather and the butterfly collectives, held against the
reference's sharded runs (``tests/_torch_ranks.py``) and the port's
answers without a mesh."""
import pytest

from _torch_ranks import PATHS, assert_answers, run_ranks, serve_case

CASE = serve_case("k3x22", "xor-dpf-k", [(2, 2)], ["gather", "butterfly"],
                  single=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("serve", {"cases": [CASE]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[CASE])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("collective", ["gather", "butterfly"])
def test_answers_equal_the_reference(runs, collective, path):
    assert_answers(runs, CASE, (2, 2), collective, path)
