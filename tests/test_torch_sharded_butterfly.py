"""The sharded ``PIRServer`` of xor-dpf-2 under the butterfly collective,
held against the reference's sharded run (``tests/_torch_ranks.py``).

The butterfly is log2(P) rounds of paired exchanges over the shard axis.
The ports' answers on the ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` meshes,
on every path it has on the CPU, equal the reference's butterfly answers
on the same mesh shapes and the port's answers without a mesh (which
``test_torch_sharded_serve.py`` holds to the reference's one-device
answers). xor-dpf-k's butterfly on ``(4, 1)``, a one-shard axis, rides
here too.
"""
import pytest

from _torch_ranks import MESHES, PATHS, assert_answers, run_ranks, serve_case

CASE = serve_case("x2b", "xor-dpf-2", MESHES, ["butterfly"], single=False)
CASE_K = serve_case("k3b41", "xor-dpf-k", [(4, 1)], ["butterfly"],
                    single=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("serve", {"cases": [CASE, CASE_K]},
                     tmp_path_factory.mktemp("ranks"),
                     ref_spec=[CASE, CASE_K])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_answers_equal_the_reference(runs, mesh, path):
    assert_answers(runs, CASE, mesh, "butterfly", path)


@pytest.mark.parametrize("path", PATHS)
def test_k_server_answers_on_one_shard_equal_the_reference(runs, path):
    assert_answers(runs, CASE_K, (4, 1), "butterfly", path)
