"""Port parity: the kernels' plain versions against the reference kernels.

The reference Pallas kernels run in interpret mode on the CPU (as
tests/test_kernels.py and tests/test_fused_scan.py run them); the port's
wrappers take their plain PyTorch versions for CPU tensors. Integer-exact:
every comparison is array equality. The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dpf as ref_dpf
from repro.core import pir as ref_pir
from repro.engine import backend as ref_backend
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch import convert
from repro_torch.core import dpf
from repro_torch.engine import backend
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import dpxor as kd
from repro_torch.kernels import fused_scan as kf

RNG = np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# dpXOR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,r,w,tile", [
    (1, 64, 8, 64),
    (4, 256, 8, 64),
    (3, 128, 5, 128),      # odd record width
])
def test_dpxor_plain_matches_reference(q, r, w, tile):
    db = RNG.integers(0, 1 << 32, size=(r, w), dtype=np.uint32)
    bits = RNG.integers(0, 2, size=(q, r), dtype=np.uint32)
    want_kernel = np.asarray(ref_ops.dpxor(jnp.asarray(db), jnp.asarray(bits),
                                           tile_r=tile))
    want_ref = np.asarray(ref_ref.dpxor_ref(jnp.asarray(db),
                                            jnp.asarray(bits)))
    got = _u(ops.dpxor(_t(db), _t(bits)))
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


def test_dpxor_plain_row_blocks_match_one_pass(monkeypatch):
    """The plain version's row blocking does not change the answer."""
    db = _t(RNG.integers(0, 1 << 32, size=(100, 4), dtype=np.uint32))
    bits = _t(RNG.integers(0, 2, size=(3, 100), dtype=np.uint32))
    whole = kd.dpxor_plain(db, bits)
    monkeypatch.setattr(kd, "_PLAIN_ELEMS", 7 * 3 * 4)   # 7-row blocks
    assert torch.equal(kd.dpxor_plain(db, bits), whole)


@pytest.mark.parametrize("row", [0, 97, 255])
def test_dpxor_onehot_selects_row(row):
    db = RNG.integers(0, 1 << 32, size=(256, 8), dtype=np.uint32)
    bits = np.zeros((1, 256), np.uint32)
    bits[0, row] = 1
    np.testing.assert_array_equal(_u(ops.dpxor(_t(db), _t(bits)))[0], db[row])


def test_dpxor_rejects_mismatched_bits():
    db = _t(np.zeros((8, 2), np.uint32))
    with pytest.raises(ValueError):
        kd.dpxor_plain(db, _t(np.zeros((1, 4), np.uint32)))


def test_xor_fold_matches_numpy_on_odd_lengths():
    x = RNG.integers(0, 1 << 32, size=(13, 3), dtype=np.uint32)
    np.testing.assert_array_equal(_u(kd.xor_fold(_t(x), 0)),
                                  np.bitwise_xor.reduce(x, axis=0))
    assert _u(kd.xor_fold(_t(x[:0]), 0)).tolist() == [0, 0, 0]


def test_wrappers_count_plain_calls_on_cpu():
    ops.reset_counts()
    db = _t(np.ones((16, 2), np.uint32))
    ops.dpxor(db, _t(np.ones((1, 16), np.uint32)))
    assert ops.counts()["dpxor"] == {"launches": 0, "plain_calls": 1}
    ops.reset_counts()
    assert ops.counts()["dpxor"] == {"launches": 0, "plain_calls": 0}


def test_cuda_ops_refuse_cpu_tensors():
    """The registered ops run only on the card; the CPU route is the
    wrapper's plain version, never a silent fallback inside the op."""
    db = _t(np.ones((16, 2), np.uint32))
    bits = _t(np.ones((1, 16), np.uint32))
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.ops.repro_torch.dpxor(db, bits)
    with pytest.raises(ValueError, match="CUDA"):
        build.require_cuda_words("db_words", db, 2)


def test_ref_module_names_the_plain_versions():
    assert ref.dpxor_ref is kd.dpxor_plain
    assert ref.fused_scan_xor_ref is kf.fused_scan_xor_plain


# ---------------------------------------------------------------------------
# Fused expand + scan (tests/test_fused_scan.py's cases)
# ---------------------------------------------------------------------------

LOG_N = 5
N = 1 << LOG_N
W = 2
IDXS = [0, 13, 31]


@pytest.fixture(scope="module")
def fused_setup():
    rng = np.random.default_rng(23)
    db = rng.integers(0, 1 << 32, size=(N, W), dtype=np.uint32)
    keys = ref_dpf.stack_keys([ref_dpf.gen_keys(rng, i, LOG_N)[0]
                               for i in IDXS])
    port_keys = convert.keys_from_reference(
        party=keys.party, log_n=keys.log_n,
        root_seed=np.asarray(keys.root_seed), cw_seed=np.asarray(keys.cw_seed),
        cw_t=np.asarray(keys.cw_t), rounds=keys.rounds)
    return db, keys, port_keys


def _port_fused(db, keys, clog, start_block=0, log_local=LOG_N):
    roots, t_roots = dpf.eval_roots_batch(keys, start_block, log_local, clog)
    lvl0 = keys.log_n - clog
    return ops.fused_scan_xor(convert.database_from_reference(db), roots,
                              t_roots, keys.cw_seed[:, lvl0:, :],
                              keys.cw_t[:, lvl0:, :])


def _ref_fused(db, keys, tile_r, clog, depth, start_block=0,
               log_local=LOG_N):
    roots, t_roots = ref_dpf.eval_roots_batch(keys, start_block, log_local,
                                              clog)
    lvl0 = keys.log_n - clog
    return np.asarray(ref_ops.fused_scan_xor(
        jnp.asarray(db), roots, t_roots, keys.cw_seed[:, lvl0:, :],
        keys.cw_t[:, lvl0:, :], tile_r=tile_r, depth=depth))


@pytest.mark.parametrize("tile_r,clog,depth", [(8, 3, 2), (32, 0, 1)])
def test_fused_plain_matches_reference_kernel(fused_setup, tile_r, clog,
                                              depth):
    db, keys, port_keys = fused_setup
    want = _ref_fused(db, keys, tile_r, clog, depth)
    got = _u(_port_fused(db, port_keys, clog))
    np.testing.assert_array_equal(got, want)
    bits = ref_dpf.eval_bits_batch(keys, 0, LOG_N)
    oracle = np.asarray(jax.vmap(lambda b: ref_pir.dpxor(jnp.asarray(db),
                                                         b))(bits))
    np.testing.assert_array_equal(got, oracle)


def test_fused_plain_start_block_matches_reference(fused_setup):
    """Shard-local evaluation: start_block offsets the GGM descent."""
    db, keys, port_keys = fused_setup
    log_local = LOG_N - 2
    rows = 1 << log_local
    for blk in (1, 3):
        shard = db[blk * rows:(blk + 1) * rows]
        want = _ref_fused(shard, keys, 4, 2, 2, blk, log_local)
        got = _u(_port_fused(shard, port_keys, 2, blk, log_local))
        np.testing.assert_array_equal(got, want, err_msg=f"shard {blk}")


def test_fused_plain_chunk_blocks_match_one_pass(fused_setup, monkeypatch):
    db, _, port_keys = fused_setup
    whole = _port_fused(db, port_keys, 2)
    monkeypatch.setattr(kf, "_PLAIN_LEAVES", 3 * 4 * 3)   # 3-chunk blocks
    assert torch.equal(_port_fused(db, port_keys, 2), whole)


def test_fused_plain_rejects_wrong_chunking(fused_setup):
    db, _, port_keys = fused_setup
    roots, t_roots = dpf.eval_roots_batch(port_keys, 0, LOG_N, 3)
    with pytest.raises(ValueError, match="chunk roots"):
        kf.fused_scan_xor_plain(convert.database_from_reference(db)[:16],
                                roots, t_roots, port_keys.cw_seed[:, 2:, :],
                                port_keys.cw_t[:, 2:, :])


# ---------------------------------------------------------------------------
# Tile legalization and the build module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,tile_r,clog", [
    (1 << 25, 2048, 12), (1 << 10, 2048, 12), (96, 64, 6), (32, 8, 0)])
def test_fused_tile_matches_reference(rows, tile_r, clog):
    assert ops.fused_tile(rows, tile_r, clog) == \
        ref_ops.fused_tile(rows, tile_r, clog)


@pytest.mark.parametrize("dim,req,pow2", [
    (96, 2048, True), (96, 40, False), (1 << 20, 3000, True), (97, 10, False)])
def test_legal_tile_matches_reference(dim, req, pow2):
    assert backend.legal_tile(dim, req, pow2=pow2) == \
        ref_backend.legal_tile(dim, req, pow2=pow2)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(build.BuildError, match="nvcc"):
        build.nvcc_path()


def test_library_names_hash_sources_and_flags(monkeypatch):
    path = build.library_path("dpxor")
    assert path.parent == build.BUILD_DIR and "dpxor-" in path.name
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("dpxor") != path
