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
    (2, 128, 3, 64),       # 12-byte records
    (2, 128, 9, 64),       # 36-byte records (checksum column)
    (3, 64, 32, 64),       # 128-byte records
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


# ---------------------------------------------------------------------------
# Every record width (12-, 36- and 128-byte records past the fixed-width
# instances): the plain versions against the reference, the wrappers'
# dispatch, the instance each width selects
# ---------------------------------------------------------------------------

#: record widths in bytes past the kernels' fixed-width instances: 12 (W =
#: 3), 36 (a 32-byte payload and its checksum word, W = 9) and 128 (W = 32)
ANY_WIDTHS = [12, 36, 128]


@pytest.mark.parametrize("item_bytes", ANY_WIDTHS)
@pytest.mark.parametrize("q", [1, 3])
def test_pir_gemm_plain_any_width_matches_reference(item_bytes, q):
    s = RNG.integers(-128, 128, size=(q, 64)).astype(np.int8)
    d = RNG.integers(-128, 128, size=(64, item_bytes)).astype(np.int8)
    want = np.asarray(ref_ops.pir_gemm(jnp.asarray(s), jnp.asarray(d),
                                       tile_q=1, tile_r=64, tile_l=4))
    got = ops.pir_gemm(convert.bytes_from_reference(s),
                       convert.bytes_from_reference(d)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("item_bytes", ANY_WIDTHS)
@pytest.mark.parametrize("clog", [0, 3])
def test_fused_xor_plain_any_width_matches_reference(fused_setup, item_bytes,
                                                     clog):
    _, keys, port_keys = fused_setup
    db = np.random.default_rng(item_bytes).integers(
        0, 1 << 32, size=(N, item_bytes // 4), dtype=np.uint32)
    want = _ref_fused(db, keys, 8, clog, 2)
    np.testing.assert_array_equal(_u(_port_fused(db, port_keys, clog)), want)


@pytest.mark.parametrize("item_bytes", ANY_WIDTHS + [96, 256, 1056])
@pytest.mark.parametrize("party", [0, 1])
def test_fused_add_plain_any_width_matches_reference(item_bytes, party):
    rng = np.random.default_rng(item_bytes + party)
    db = rng.integers(-128, 128, size=(N, item_bytes)).astype(np.int8)
    pairs = [ref_dpf.gen_keys(rng, i, LOG_N, payload=np.array([1], np.uint32),
                              payload_mod=256) for i in IDXS]
    key = ref_dpf.stack_keys([p[party] for p in pairs])
    port_key = convert.keys_from_reference(
        party=key.party, log_n=key.log_n, root_seed=np.asarray(key.root_seed),
        cw_seed=np.asarray(key.cw_seed), cw_t=np.asarray(key.cw_t),
        cw_final=np.asarray(key.cw_final), rounds=key.rounds)
    clog = 3
    lvl0 = LOG_N - clog

    def inputs(k, eval_roots):
        roots, t_roots = eval_roots(k, 0, LOG_N, clog)
        return (roots, t_roots, k.cw_seed[:, lvl0:, :], k.cw_t[:, lvl0:, :],
                k.cw_final[:, 0])

    want = np.asarray(ref_ops.fused_scan_bytes(
        jnp.asarray(db), *inputs(key, ref_dpf.eval_roots_batch),
        party=party, tile_r=8, depth=2))
    got = ops.fused_scan_bytes(convert.bytes_from_reference(db),
                               *inputs(port_key, dpf.eval_roots_batch),
                               party=party).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("item_bytes", ANY_WIDTHS)
@pytest.mark.parametrize("q", [1, 32])
def test_wrappers_take_any_width_on_the_plain_versions(item_bytes, q):
    """On CPU tensors every wrapper takes its plain version at these
    widths (the count says so) and agrees with the plain function."""
    from repro_torch.kernels import pir_matmul as km
    rng = np.random.default_rng(item_bytes * q)
    r, w = 64, item_bytes // 4
    db = _t(rng.integers(0, 1 << 32, size=(r, w), dtype=np.uint32))
    bits = _t(rng.integers(0, 2, size=(q, r), dtype=np.uint32))
    shares = torch.from_numpy(rng.integers(-128, 128, size=(q, r)).astype(
        np.int8))
    keys = dpf.gen_keys_batch(rng, rng.integers(0, r, size=q), 6,
                              payload=np.array([1], np.uint32))[1]
    roots, t_roots = dpf.eval_roots_batch(keys, 0, 6, 3)
    lv = (keys.cw_seed[:, 3:], keys.cw_t[:, 3:])
    ops.reset_counts()
    runs = [  # (wrapper, plain version, args, keywords, answer columns)
        (kd.dpxor, kd.dpxor_plain, (db, bits), {}, w),
        (km.pir_gemm, km.pir_gemm_plain, (shares, db.view(torch.int8)), {},
         item_bytes),
        (kf.fused_scan_xor, kf.fused_scan_xor_plain,
         (db, roots, t_roots, *lv), {"rounds": keys.rounds}, w),
        (kf.fused_scan_add, kf.fused_scan_add_plain,
         (db.view(torch.int8), roots, t_roots, *lv, keys.cw_final[:, 0]),
         {"party": 1, "rounds": keys.rounds}, item_bytes),
    ]
    for wrapper, plain, args, kw, cols in runs:
        got = wrapper(*args, **kw)
        assert got.shape == (q, cols)
        assert torch.equal(got, plain(*args, **kw))
    counts = ops.counts()
    for name in ("dpxor", "pir_gemm", "fused_scan_xor", "fused_scan_add"):
        assert counts[name] == {"launches": 0, "plain_calls": 1}


@pytest.mark.parametrize("words,queries,want", [
    (8, 1, "12dpxor_kernelILi8ELi1EE"),
    (16, 32, "12dpxor_kernelILi16ELi8EE"),
    (9, 1, "16dpxor_any_kernelILi1EE"),
    (32, 3, "16dpxor_any_kernelILi4EE"),
])
def test_dpxor_instance_names_the_dispatched_template(words, queries, want):
    assert kd.instance(words, queries) == want


def test_instances_follow_each_kernels_dispatch():
    from repro_torch.kernels import lwe_matmul as kl, pir_matmul as km
    assert kf.instance_xor(8) == "21fused_scan_xor_kernelILi8ELb1EE"
    assert kf.instance_xor(3) == "21fused_scan_xor_kernelILi8ELb0EE"
    assert kf.instance_xor(9) == "21fused_scan_xor_kernelILi16ELb0EE"
    # 128-byte records: the exact instance (eight 16-byte loads per row)
    assert kf.instance_xor(32) == "21fused_scan_xor_kernelILi32ELb1EE"
    # past 32 words: the wide instance, by the batch's query block
    assert kf.instance_xor(40) == "26fused_scan_xor_wide_kernelILi8ELb1EE"
    assert kf.instance_xor(40, queries=4) == \
        "26fused_scan_xor_wide_kernelILi4ELb1EE"
    assert kf.instance_xor(33, queries=1) == \
        "26fused_scan_xor_wide_kernelILi1ELb0EE"
    assert kf.instance_add(32) == "21fused_scan_add_kernelILi32ELb1EE"
    assert kf.instance_add(12) == "21fused_scan_add_kernelILi16ELb0EE"
    assert kf.instance_add(36) == "21fused_scan_add_kernelILi48ELb0EE"
    assert kf.instance_add(64) == "21fused_scan_add_kernelILi64ELb0EE"
    # past 64 bytes: the split instance, 16-byte row loads where L % 16 == 0
    assert kf.instance_add(96) == "27fused_scan_add_split_kernelILb1EE"
    assert kf.instance_add(128) == "27fused_scan_add_split_kernelILb1EE"
    assert kf.instance_add(256) == "27fused_scan_add_split_kernelILb1EE"
    assert kf.instance_add(100) == "27fused_scan_add_split_kernelILb0EE"
    # past 1024 bytes the same instance, in passes of 1024 bytes
    assert kf.instance_add(1056) == "27fused_scan_add_split_kernelILb1EE"
    assert kf.instance_add(1060) == "27fused_scan_add_split_kernelILb0EE"
    assert km.instance(32, 5) == "15pir_gemm_kernelILi32ELi8EE"
    assert km.instance(36, 2) == "19pir_gemm_any_kernelILi2EE"
    assert kl.instance(1) == "15lwe_gemm_kernelILi1EE"
    # the checksum hint (M = 36): one 40-row tile, so A streams once
    assert kl.instance(36) == "20lwe_gemm_tall_kernelILi40EE"


@pytest.mark.parametrize("words,align,want", [
    (32, 16, "21fused_scan_xor_kernelILi32ELb1EE"),   # an allocation
    (32, 4, "21fused_scan_xor_kernelILi32ELb0EE"),    # a row slice
    (40, 16, "26fused_scan_xor_wide_kernelILi8ELb1EE"),  # 16-byte loads
    (40, 4, "26fused_scan_xor_wide_kernelILi8ELb0EE"),   # a row slice
    (33, 16, "26fused_scan_xor_wide_kernelILi8ELb0EE"),  # 132-byte rows
    (1280, 16, "26fused_scan_xor_wide_kernelILi8ELb1EE"),
    (3585, 16, "26fused_scan_xor_wide_kernelILi8ELb0EE"),
    (16, 8, "21fused_scan_xor_kernelILi16ELb0EE"),
    (2, 8, "21fused_scan_xor_kernelILi2ELb1EE"),
    (1, 4, "21fused_scan_xor_kernelILi1ELb1EE"),
])
def test_fused_xor_instance_follows_width_and_alignment(words, align, want):
    """Up to 32 words: the exact instance where the DB base is aligned for
    its vector loads (``common.cuh row_align``), the word-read group
    otherwise. Past 32 words: the wide instance, with 16-byte loads where
    the width is whole 16-byte words and the base 16-byte aligned."""
    assert kf.instance_xor(words, align) == want


@pytest.mark.parametrize("queries,qb", [(1, 1), (2, 2), (3, 4), (4, 4),
                                        (5, 8), (8, 8), (9, 8), (16, 8),
                                        (32, 8), (33, 8), (96, 8)])
def test_fused_xor_wide_instance_follows_the_batch(queries, qb):
    """The wide instance keeps one accumulator per query and word a thread
    folds: the least query block that holds the batch, past 8 queries
    blocks of 8; records of up to 32 words keep one instance whatever the
    batch."""
    assert kf.instance_xor(1280, queries=queries) == build.mangled(
        "fused_scan_xor_wide_kernel", qb, True)
    assert kf.instance_xor(3584, 4, queries) == build.mangled(
        "fused_scan_xor_wide_kernel", qb, False)
    assert kf.instance_xor(32, queries=queries) == kf.instance_xor(32)


@pytest.mark.parametrize("m,p,want", [
    (32, 32, "15lwe_gemm_kernelILi32EE"),              # the answer at L = 32
    (33, 1024, "20lwe_gemm_tall_kernelILi40EE"),       # hints of 33..40 rows
    (36, 1024, "20lwe_gemm_tall_kernelILi40EE"),
    (40, 1024, "20lwe_gemm_tall_kernelILi40EE"),
    (41, 1024, "15lwe_gemm_kernelILi32EE"),            # 32-row tiles past 40
    (32, 33, "20lwe_gemm_wide_kernelILi32ELi4EE"),     # answers at 33..40
    (32, 36, "20lwe_gemm_wide_kernelILi32ELi4EE"),
    (1, 36, "20lwe_gemm_wide_kernelILi1ELi4EE"),
    (32, 40, "20lwe_gemm_wide_kernelILi32ELi8EE"),
    (36, 36, "20lwe_gemm_wide_kernelILi32ELi4EE"),
    (1 << 22, 36, "20lwe_gemm_wide_kernelILi32ELi4EE"),  # A.S^T, 36 queries
    (1 << 22, 40, "20lwe_gemm_wide_kernelILi32ELi8EE"),
    (1 << 22, 32, "15lwe_gemm_kernelILi32EE"),
    (32, 41, "15lwe_gemm_kernelILi32EE"),              # column tiles past 40
])
def test_lwe_gemm_instance_follows_rows_and_columns(m, p, want):
    from repro_torch.kernels import lwe_matmul as kl
    assert kl.instance(m, p) == want


def test_lwe_gemm_plan_reads_the_instance_its_shape_selects():
    """The LWE plan's launch check looks up the instance of its bucket
    (M) and stored record width (P): the wide one at 36 columns."""
    from repro_torch import engine
    from repro_torch.engine.kernels import ProblemShape
    from repro_torch.kernels import lwe_matmul as kl
    desc = engine.get_kernel("lwe-gemm-cuda")
    for q, item_bytes in ((32, 36), (1, 36), (32, 32), (8, 40)):
        assert desc.instance_fn(ProblemShape(q, 1 << 10, item_bytes)) == \
            kl.instance(q, item_bytes)
    assert "wide" in desc.instance_fn(ProblemShape(32, 1 << 10, 36))


#: ptxas's report as the build records it (-Xptxas -v), for two instances
_PTXAS = [
    "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__f0_8_dpxor_cu"
    "_d12dpxor_kernelILi16ELi8EEEvPKjS2_Pjxi' for 'sm_90a'",
    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 199 registers, used 1 barriers, 4096 bytes smem",
    "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__f0_8_dpxor_cu"
    "_d16dpxor_any_kernelILi8EEEvPKjS2_Pjxii' for 'sm_90a'",
    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 44 registers, used 1 barriers, 8192 bytes smem",
]


def test_registers_are_read_for_the_instance_a_width_selects(monkeypatch):
    from repro_torch import engine
    from repro_torch.engine.kernels import ProblemShape
    monkeypatch.setitem(build.RECORDS, "dpxor", build.BuildRecord(
        "dpxor", "lib", ptxas=_PTXAS))
    assert build.registers("dpxor") == 199
    assert build.registers("dpxor", kd.instance(16, 8)) == 199
    assert build.registers("dpxor", kd.instance(9, 8)) == 44
    assert build.registers("dpxor", kd.instance(4, 1)) is None
    desc = engine.get_kernel("xor-materialize-cuda")
    assert desc.instance_fn(ProblemShape(8, 1 << 10, 36)) == \
        kd.instance(9, 8)
    # 199 registers x 256 threads fit the SM's 65,536: both launch
    for item_bytes in (64, 36):
        assert desc.launch_ok(ProblemShape(8, 1 << 10, item_bytes), {})


#: the same for the fused add: the 32-byte exact instance and the split one
_PTXAS_ADD = [
    "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__f0_17_fused"
    "_scan_add_cu_d21fused_scan_add_kernelILi32ELb1EEEvPKjS2_S2_S2_S2_S2_Pjx"
    "iiiiii' for 'sm_90a'",
    "480 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 96 registers, used 1 barriers, 8192 bytes smem",
    "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__f0_17_fused"
    "_scan_add_cu_d27fused_scan_add_split_kernelILb1EEEvPKjS2_S2_S2_S2_S2_Pj"
    "xiiiiiii' for 'sm_90a'",
    "480 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 300 registers, used 1 barriers, 8192 bytes smem",
]


def test_launch_ok_reads_the_split_instance_registers(monkeypatch):
    """Past 64 bytes the fused add's plan reads the split instance's
    registers: a count too large for 256 threads (made up here) refuses
    128- and 256-byte records and leaves 32-byte ones launching."""
    from repro_torch import engine
    from repro_torch.engine.kernels import ProblemShape
    monkeypatch.setitem(build.RECORDS, "fused_scan_add", build.BuildRecord(
        "fused_scan_add", "lib", ptxas=_PTXAS_ADD))
    desc = engine.get_kernel("gemm-fused-cuda")
    assert build.registers("fused_scan_add", kf.instance_add(128)) == 300
    assert build.registers("fused_scan_add", kf.instance_add(32)) == 96
    assert desc.launch_ok(ProblemShape(32, 1 << 10, 32), {})
    for item_bytes in (128, 256):
        assert desc.instance_fn(ProblemShape(32, 1 << 10, item_bytes)) == \
            kf.instance_add(item_bytes)
        assert not desc.launch_ok(ProblemShape(32, 1 << 10, item_bytes), {})


@pytest.mark.parametrize("scheme", ["xor-dpf-2", "additive-dpf-2",
                                    "xor-dpf-k", "lwe-simple-1"])
@pytest.mark.parametrize("item_bytes", [4, 8, 16, 32, 64])
def test_plan_for_on_the_cpu_is_unchanged_for_the_widths_that_worked(
        scheme, item_bytes):
    """plan_for does not read the record width: on the CPU every width
    that worked before gets the same plan at every bucket as the 32-byte
    records, and so does a checksummed config."""
    from repro_torch.config import PIRConfig
    from repro_torch.core.protocol import plan_for
    base = PIRConfig(n_items=1 << 14, protocol=scheme,
                     n_servers=1 if scheme == "lwe-simple-1" else 3)
    for q in (1, 2, 32):
        want = plan_for(base, q, backend="cpu")
        for cfg in (PIRConfig(**{**base.__dict__, "item_bytes": item_bytes}),
                    PIRConfig(**{**base.__dict__, "item_bytes": item_bytes,
                                 "checksum": True})):
            assert plan_for(cfg, q, backend="cpu") == want
            assert plan_for(cfg, q, backend="cuda") == plan_for(
                base, q, backend="cuda")


# On the card: B1-B4 against their plain versions at every width (the
# fixed-width 32 bytes for contrast), at Q = 1 and Q = 32 (at Q = 32 all
# lanes of a fused kernel's warp are queries), and B5 at P = 36

CARD_WIDTHS = [12, 36, 128, 32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card; "
                    "chip_smoke.py's check_widths holds the same kernels "
                    "at full size)")
    return torch.device("cuda")


def _card_db(card, rows, item_bytes, seed, offset_words=0):
    """A ``[rows, item_bytes / 4]`` word DB on the card, starting
    ``offset_words`` words into its allocation (1: only 4-byte aligned)."""
    w = item_bytes // 4
    flat = np.random.default_rng(seed).integers(
        0, 1 << 32, size=rows * w + offset_words, dtype=np.uint32)
    return _t(flat).to(card)[offset_words:].view(rows, w)


@pytest.mark.cuda
@pytest.mark.parametrize("item_bytes", CARD_WIDTHS)
@pytest.mark.parametrize("q", [1, 5, 32])
def test_dpxor_kernel_any_width_on_the_card(card, item_bytes, q):
    db = _card_db(card, 1 << 12, item_bytes, q)
    bits = torch.randint(0, 2, (q, 1 << 12), dtype=torch.int32, device=card)
    assert torch.equal(kd.dpxor(db, bits), kd.dpxor_plain(db, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("item_bytes", [4, 8, 36])
def test_dpxor_kernel_takes_a_row_slice_on_the_card(card, item_bytes):
    """An operand only 4-byte aligned, as a row slice of 4-byte records or
    of 36-byte ones is: the kernel reads it word by word; the bits are cut
    from a flat buffer at a 4-byte offset too."""
    db = _card_db(card, 1 << 12, item_bytes, 7, offset_words=1)
    flat = torch.randint(0, 2, (3 * (1 << 12) + 1,), dtype=torch.int32,
                         device=card)
    bits = flat[1:].view(3, 1 << 12)
    assert db.data_ptr() % 16 and bits.data_ptr() % 16
    assert torch.equal(kd.dpxor(db, bits), kd.dpxor_plain(db, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("item_bytes", CARD_WIDTHS)
@pytest.mark.parametrize("q", [1, 32])
def test_pir_gemm_kernel_any_width_on_the_card(card, item_bytes, q):
    from repro_torch.kernels import pir_matmul as km
    db = _card_db(card, 1 << 12, item_bytes, q).view(torch.int8)
    shares = torch.randint(-128, 128, (q, 1 << 12), dtype=torch.int8,
                           device=card)
    assert torch.equal(km.pir_gemm(shares, db), km.pir_gemm_plain(shares, db))
    sliced = _card_db(card, 1 << 12, item_bytes, 3, 1).view(torch.int8)
    assert torch.equal(km.pir_gemm(shares, sliced),
                       km.pir_gemm_plain(shares, sliced))


def _card_fused_inputs(card, q, log_n, clog, payload=None):
    keys = dpf.gen_keys_batch(np.random.default_rng(q + clog),
                              list(range(3, 3 + q)), log_n,
                              payload=payload)[q % 2].to(card)
    roots, t_roots = dpf.eval_roots_batch(keys, 0, log_n, clog)
    lvl0 = keys.log_n - clog
    return keys, (roots, t_roots, keys.cw_seed[:, lvl0:].contiguous(),
                  keys.cw_t[:, lvl0:].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("item_bytes", CARD_WIDTHS)
@pytest.mark.parametrize("q,clog,offset", [(1, 6, 0), (8, 0, 1), (32, 5, 0),
                                           (32, 5, 1)])
def test_fused_xor_kernel_any_width_on_the_card(card, item_bytes, q, clog,
                                                offset):
    keys, inputs = _card_fused_inputs(card, q, 12, clog)
    db = _card_db(card, 1 << 12, item_bytes, clog, offset)
    assert torch.equal(kf.fused_scan_xor(db, *inputs, rounds=keys.rounds),
                       kf.fused_scan_xor_plain(db, *inputs,
                                               rounds=keys.rounds))


#: record widths of the wide instance on the card: 16-byte loads at 516,
#: 5,120 and 14,336 B, word loads at 132 and 1,028 B (not whole 16-byte
#: words); offset 1 makes every one a 4-byte aligned row slice
WIDE_CARD_WIDTHS = [132, 516, 1028, 5120, 14336]


@pytest.mark.cuda
@pytest.mark.parametrize("item_bytes", WIDE_CARD_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("q", [1, 4, 32, 33])
@pytest.mark.parametrize("clog", [0, 1, 5, 11])
def test_fused_xor_wide_kernel_on_the_card(card, item_bytes, offset, q,
                                           clog):
    """Rows wider than 32 words take the wide instance (each leaf expanded
    once per launch, each row read once): exact against the plain version
    at every width, alignment, batch (33: two query groups) and chunk log
    (0: the chunk roots are the leaves; 11: two chunks of 2^11 rows)."""
    keys, inputs = _card_fused_inputs(card, q, 12, clog)
    db = _card_db(card, 1 << 12, item_bytes, q + clog, offset)
    assert (db.data_ptr() % 16 == 0) == (offset == 0)
    before = kf.count.launches
    assert torch.equal(kf.fused_scan_xor(db, *inputs, rounds=keys.rounds),
                       kf.fused_scan_xor_plain(db, *inputs,
                                               rounds=keys.rounds))
    assert kf.count.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("q,clog,offset", [(1, 0, 0), (32, 1, 0), (5, 7, 0),
                                           (1, 0, 1), (32, 1, 1)])
def test_fused_xor_kernel_at_128_bytes_on_the_card(card, q, clog, offset):
    """128-byte records: offset 0 takes the exact instance (16-byte row
    loads), offset 1 (a 4-byte-aligned base) the word-read group; clog 0
    and 1 are the smallest subtrees."""
    keys, inputs = _card_fused_inputs(card, q, 12, clog)
    db = _card_db(card, 1 << 12, 128, clog + 1, offset)
    assert (db.data_ptr() % 16 == 0) == (offset == 0)
    assert torch.equal(kf.fused_scan_xor(db, *inputs, rounds=keys.rounds),
                       kf.fused_scan_xor_plain(db, *inputs,
                                               rounds=keys.rounds))


@pytest.mark.cuda
@pytest.mark.parametrize("item_bytes",
                         CARD_WIDTHS + [96, 256, 512, 1056, 2048])
@pytest.mark.parametrize("q,clog,party,offset", [
    (1, 6, 0, 0), (8, 0, 1, 1), (32, 5, 1, 0), (32, 5, 0, 1), (4, 1, 1, 0)])
def test_fused_add_kernel_any_width_on_the_card(card, item_bytes, q, clog,
                                                party, offset):
    """Past 64 bytes the split instance: 96 bytes (P = 4 lanes of 32
    columns, the fourth lane's group empty), 128 (P = 4), 256 (P = 8),
    512 (P = 16: two queries per warp), and past 1024 bytes P = 32 (one
    query per warp, no cross-lane reduction) in passes of 1024 bytes:
    1056 (a second pass where one lane holds columns) and 2048 (two full
    passes). clog 0 and 1 leave lanes without a leaf of their own."""
    keys, inputs = _card_fused_inputs(card, q, 12, clog,
                                      payload=np.array([1], np.uint32))
    db = _card_db(card, 1 << 12, item_bytes, clog, offset).view(torch.int8)
    cwf = keys.cw_final[:, 0].contiguous()
    got = kf.fused_scan_add(db, *inputs, cwf, party=party, rounds=keys.rounds)
    want = kf.fused_scan_add_plain(db, *inputs, cwf, party=party,
                                   rounds=keys.rounds)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,p", [(1, 4096, 36), (32, 4096, 36),
                                   (36, 4096, 1024), (32, 4096, 33),
                                   (32, 4096, 40), (33, 4096, 1024),
                                   (40, 4096, 1024), (41, 4096, 1024),
                                   (36, 4096, 36), (69, 4096, 33),
                                   (4096, 1024, 36), (4096, 1024, 40)])
def test_lwe_gemm_kernel_at_the_checksum_width_on_the_card(card, m, k, p):
    """B5 at the checksum database's answer shapes ([Q, N] x [N, 36]) and
    its hint shape ([36, N] x A), full-range operands so every sum wraps;
    33 and 40 columns (the wide instance's 4 and 8 remainder columns), 33
    and 40 hint rows (one 40-row tile) and 41 (32-row tiles again); the
    wide instance over several 32-row M tiles, the last one partial, and at
    the client's A.S^T for a batch of 36 or 40 queries."""
    from repro_torch.kernels import lwe_matmul as kl
    gen = torch.Generator(device=card).manual_seed(m + p)
    a = torch.randint(-(1 << 31), (1 << 31) - 1, (m, k), generator=gen,
                      device=card, dtype=torch.int32)
    b = torch.randint(-(1 << 31), (1 << 31) - 1, (k, p), generator=gen,
                      device=card, dtype=torch.int32)
    assert torch.equal(kl.lwe_gemm(a, b), kl.lwe_gemm_plain(a, b))


def test_ptxas_report_reads_registers_and_spills(monkeypatch):
    monkeypatch.setitem(build.RECORDS, "dpxor", build.BuildRecord(
        "dpxor", "lib", ptxas=_PTXAS))
    report = build.ptxas_report("dpxor")
    assert len(report) == 2
    any8 = next(v for k, v in report.items() if kd.instance(9, 8) in k)
    assert any8 == {"registers": 44, "stack": 0, "spill_stores": 0,
                    "spill_loads": 0}
    assert build.ptxas_report("no-such-library") == {}
