"""The port's device mesh and cross-shard algebra against the reference's.

Four ``gloo`` ranks (``tests/_torch_ranks.py``) build meshes from the same
``MeshConfig`` shapes and ``make_local_mesh`` clips as the reference does
on four XLA CPU devices (``tests/_ref_sharded.py``): the shapes, axis
names, ``mesh_axis_size``, ``batch_axes``, ``pir_cluster_axes`` and
``pir_shard_axis`` agree, and each rank's coordinates are its row-major
place in the grid. ``xor_allreduce_gather`` and
``xor_allreduce_butterfly`` over a ``model`` axis of size 2 and 4 give
every rank what the reference's give its device under ``shard_map`` on
the same seeded partials. The protocols' ``key_specs`` match the
reference's for every party.
"""
import json

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks

CONFIGS = [[[1, 4], ["data", "model"]], [[2, 2], ["data", "model"]],
           [[4, 1], ["data", "model"]], [[1, 2, 2], ["pod", "data", "model"]]]
LOCAL = [[1, 1], [2, 2], [8, 8], [2, 4], [1, 3], [3, 1]]
ALLREDUCE = [{"kind": "allreduce", "name": "ar22", "mesh": [2, 2],
              "seed": 3, "shape": [4, 8]},
             {"kind": "allreduce", "name": "ar14", "mesh": [1, 4],
              "seed": 4, "shape": [5, 9]}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(
        "mesh", {"configs": CONFIGS, "local": LOCAL, "allreduce": ALLREDUCE},
        tmp_path_factory.mktemp("ranks"),
        ref_spec=[{"kind": "mesh", "name": "mesh", "configs": CONFIGS,
                   "local": LOCAL}] + ALLREDUCE)


@pytest.mark.parametrize("i", range(len(CONFIGS) + len(LOCAL)))
def test_mesh_helpers_match_the_reference(runs, i):
    results, ref = runs
    want = json.loads(str(ref["mesh"]))[i]
    for res in results:
        assert res["meshes"][i] == want
        assert res["devices"][i] == "cpu"


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_rank_coordinates_are_row_major(runs, i):
    shape, axes = CONFIGS[i]
    for r, res in enumerate(runs[0]):
        want = np.unravel_index(r, shape)
        assert res["coords"][i] == {a: int(c) for a, c in zip(axes, want)}


def test_local_meshes_leave_out_ranks_past_the_clip(runs):
    # make_local_mesh(1, 3) and (3, 1): a grid of three ranks
    for r, res in enumerate(runs[0]):
        one, three = res["coords"][-2], res["coords"][-1]
        if r < 3:
            assert one == {"data": 0, "model": r}
            assert three == {"data": r, "model": 0}
        else:
            assert one is None and three is None


@pytest.mark.parametrize("collective", ["gather", "butterfly"])
@pytest.mark.parametrize("case", ["ar22", "ar14"])
def test_xor_allreduce_matches_the_reference(runs, case, collective):
    results, ref = runs
    parts = ref[f"{case}/partials"]
    for res in results:
        c, s = res[f"{case}/coord"]
        want = ref[f"{case}/{collective}"][c, s]
        assert np.array_equal(res[f"{case}/{collective}"], want)
        # the XOR of the cluster's partials, on every rank of it
        fold = np.bitwise_xor.reduce(parts[c], axis=0)
        assert np.array_equal(want, fold)
        assert res[f"{case}/unchanged"]        # the input is not written


@pytest.mark.parametrize("size", [3, 6, 0])
def test_butterfly_needs_a_power_of_two_axis(size):
    from repro_torch.core.protocol import xor_allreduce_butterfly
    with pytest.raises(ValueError, match="power-of-two"):
        xor_allreduce_butterfly(torch.zeros(2, 3, dtype=torch.int32), None,
                                size)


def test_one_rank_butterfly_is_the_identity():
    from repro_torch.core.protocol import xor_allreduce_butterfly
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert xor_allreduce_butterfly(x, None, 1) is x


def test_single_mesh_needs_no_process_group():
    from repro_torch.launch import mesh as mesh_mod
    m = mesh_mod.make_local_mesh(4, 4, device="cpu")
    assert dict(m.shape) == {"data": 1, "model": 1}
    assert m.size == 1 and m.transport == "none" and m.group("model") is None
    assert m.coords == {"data": 0, "model": 0}
    assert m == mesh_mod.single_mesh("cpu")
    with pytest.raises(RuntimeError, match="process group"):
        from repro_torch.config import MeshConfig
        mesh_mod.make_mesh(MeshConfig(shape=(2, 2), axes=("data", "model")),
                           device="cpu")


def test_mesh_config_matches_the_reference():
    from repro.config import MeshConfig as RefMeshConfig
    from repro_torch.config import MeshConfig
    for shape, axes in CONFIGS:
        got = MeshConfig(shape=tuple(shape), axes=tuple(axes))
        want = RefMeshConfig(shape=tuple(shape), axes=tuple(axes))
        assert got.n_devices == want.n_devices
        assert got.to_dict() == want.to_dict()


def test_backend_and_transport_rules():
    from repro_torch.launch import mesh as mesh_mod
    assert mesh_mod.default_backend(4, "cpu") == "gloo"
    if not torch.cuda.is_available():
        assert mesh_mod.default_backend(4) == "gloo"
    assert mesh_mod.transport_of("gloo", torch.device("cuda", 0)) == "host"
    assert mesh_mod.transport_of("gloo", torch.device("cpu")) == "device"
    assert mesh_mod.transport_of("nccl", torch.device("cuda", 1)) == "device"
    assert mesh_mod.transport_of(None, torch.device("cpu")) == "none"


@pytest.mark.parametrize("protocol,party", [
    ("xor-dpf-2", 0), ("xor-dpf-2", 1), ("additive-dpf-2", 1),
    ("xor-dpf-k", 0), ("xor-dpf-k", 1), ("xor-dpf-k", 2),
    ("lwe-simple-1", 0)])
def test_key_specs_match_the_reference(protocol, party):
    from repro.config import PIRConfig as RefPIRConfig
    from repro.core.server import key_specs as ref_key_specs
    from repro_torch.config import PIRConfig
    from repro_torch.core.server import key_specs
    cfg = PIRConfig(n_items=1 << 12, protocol=protocol, n_servers=3)
    got = key_specs(cfg, 8, party=party)
    want = ref_key_specs(RefPIRConfig(**cfg.to_dict()), 8, party=party)
    for name in ("party", "log_n", "rounds", "n"):
        if hasattr(want, name):
            assert getattr(got, name) == getattr(want, name), name
    fields = ("ct",) if protocol == "lwe-simple-1" else (
        "root_seed", "cw_seed", "cw_t", "cw_final")
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), name
        assert g.dtype == torch.int32 and w.dtype.itemsize == 4, name


def test_meta_keys_are_the_key_specs():
    from repro_torch.configs.pir import PIR_1G
    from repro_torch.launch.dryrun import meta_keys
    from repro_torch.core.protocol import get
    keys = meta_keys(PIR_1G, 32)
    want = get(PIR_1G.protocol).key_specs(PIR_1G, 32, party=0)
    assert keys.party == 0 and keys.cw_seed.shape == want.cw_seed.shape
