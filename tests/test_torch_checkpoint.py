"""Port: the checkpoint manager (``repro_torch/checkpoint``) — the
counterparts of ``tests/test_checkpoint.py``'s seven cases, and the
on-disk layout held against the reference's (one package's checkpoint
read by the other's ``np.load``: the same directory names, files and
manifest keys)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim.optimizer import AdafactorState



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at smoke shapes torch's threads buy nothing,
    and under the suite's parallel workers they contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(5, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(100, tree, blocking=True)
    restored, meta = mgr.restore(tree)
    assert meta["step"] == 100 and meta["n_leaves"] == 3
    _equal(tree, restored)
    assert restored["params"]["b"].dtype == torch.bfloat16


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    mgr.restore(_tree())
    assert [len(v) for v in mgr.timings.values()] == [1, 1, 1]


def test_save_copies_before_returning(tmp_path):
    """The tensors are copied to the host inside save(): an in-place
    update right after an async save does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(2, tree)
    tree["params"]["w"].add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_no_tmp_dirs_counted(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")   # simulated crash artifact
    mgr.save(3, _tree(), blocking=True)
    assert mgr.all_steps() == [3]


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())
    mgr.save(1, {"params": {"w": torch.zeros(2)}}, blocking=True)
    with pytest.raises(KeyError, match="params/b missing"):
        mgr.restore({"params": {"w": torch.zeros(2), "b": torch.zeros(2)}})


def test_restore_onto_another_device(tmp_path):
    """The elastic restore's counterpart: a tree of shapes only (meta
    tensors, nothing allocated) restored onto the CPU, and a restore
    that moves every leaf to the named device."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, blocking=True)
    like = {"params": {k: torch.empty_like(v, device="meta")
                       for k, v in tree["params"].items()},
            "opt": {"step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    restored, meta = mgr.restore(like, device="cpu")
    _equal(tree, restored)
    assert all(t.device.type == "cpu"
               for t in restored["params"].values())
    moved, _ = mgr.restore(like, step=5, device=torch.device("cpu"))
    _equal(tree, moved)


def test_manifest_metadata(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(8, _tree(), metadata={"config": {"name": "x"}}, blocking=True)
    with open(tmp_path / "step_00000008" / "manifest.json") as f:
        meta = json.load(f)
    assert meta["config"]["name"] == "x"
    assert meta["step"] == 8


def test_named_tuples_and_empty_leaves(tmp_path):
    """An optimizer state: NamedTuple fields name the path, None leaves
    (the reference's ``()``) are written as nothing and come back None."""
    state = AdafactorState(step=torch.tensor(3, dtype=torch.int32),
                           vr={"w": torch.ones(4), "b": None},
                           vc={"w": torch.ones(2), "b": None},
                           v={"w": None, "b": torch.full((3,), 2.0)})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"opt": state}, blocking=True)
    with np.load(tmp_path / "step_00000001" / "proc000.npz") as z:
        assert sorted(z.files) == ["opt/step", "opt/v/b", "opt/vc/w",
                                   "opt/vr/w"]
    restored, _ = mgr.restore({"opt": state})
    got = restored["opt"]
    assert isinstance(got, AdafactorState) and got.vr["b"] is None
    assert torch.equal(got.v["b"], state.v["b"]) and int(got.step) == 3


def test_a_failed_background_write_raises_in_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000004.tmp" / "proc000.npz")  # in the way
    mgr.save(4, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                   # reported once
    assert mgr.latest_step() is None


def test_layout_matches_the_reference(tmp_path):
    """The same tree saved by both packages: the same directory and file
    names, the same leaf keys and values, the manifest's keys."""
    ref = RefManager(str(tmp_path / "ref"))
    ref.save(6, {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                            "b": jnp.ones((5,), jnp.bfloat16)},
                 "opt": {"step": jnp.asarray(7, jnp.int32)}},
             metadata={"config": {"name": "x"}}, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(
        6, _tree(), metadata={"config": {"name": "x"}}, blocking=True)
    for side in ("ref", "port"):
        assert os.listdir(tmp_path / side) == ["step_00000006"]
        assert sorted(os.listdir(tmp_path / side / "step_00000006")) == \
            ["manifest.json", "proc000.npz"]
    load = lambda side: np.load(tmp_path / side / "step_00000006" /
                                "proc000.npz")
    with load("ref") as r, load("port") as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert r[k].dtype == p[k].dtype, k
            np.testing.assert_array_equal(r[k], p[k])
    metas = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_00000006" / "manifest.json") as f:
            metas.append(json.load(f))
    assert metas[0].keys() == metas[1].keys()
