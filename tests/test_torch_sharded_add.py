"""The sharded ``PIRServer`` of the summing schemes, additive-dpf-2 (int8
GEMM, Z_256 shares) and lwe-simple-1 (int32 GEMM over seeded
ciphertexts), on the ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` meshes: each
shard's partial answer, then an int32 SUM all-reduce over the shard axis,
equal to the reference's sharded answers and to the port's answers
without a mesh (``tests/_torch_ranks.py``; the additive one-device answers
are held to the reference's in ``test_torch_sharded_serve.py``, the LWE
ones here). They ignore the collective, so the gather's plan is the one
run.
"""
import numpy as np
import pytest

from _torch_ranks import (INDICES, MESHES, N_ITEMS, PATHS, assert_answers,
                          run_ranks, serve_case)

ADD = serve_case("a2", "additive-dpf-2", MESHES, ["gather"], single=False)
LWE = serve_case("lwe", "lwe-simple-1", MESHES, ["gather"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("serve", {"cases": [ADD, LWE]},
                     tmp_path_factory.mktemp("ranks"), ref_spec=[ADD, LWE])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_additive_answers_equal_the_reference(runs, mesh, path):
    assert_answers(runs, ADD, mesh, "gather", path)


@pytest.mark.parametrize("path", ["baseline", "cuda"])
@pytest.mark.parametrize("mesh", MESHES)
def test_lwe_answers_equal_the_reference(runs, mesh, path):
    assert_answers(runs, LWE, mesh, "gather", path)


@pytest.mark.parametrize("mesh", MESHES)
def test_additive_shares_reconstruct_the_bytes(runs, mesh):
    from repro_torch.core import pir
    db = pir.make_database(np.random.default_rng(1), N_ITEMS, 32)
    d, m = mesh
    for res in runs[0]:
        rec = (res[f"a2/{d}x{m}/gather/fused-cuda/p0"].astype(np.int64)
               + res[f"a2/{d}x{m}/gather/fused-cuda/p1"]) % 256
        assert np.array_equal(rec.astype(np.uint8),
                              db[INDICES].view(np.uint8))
