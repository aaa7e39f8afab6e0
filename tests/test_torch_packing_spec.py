"""Port parity: the packing functions and ``DatabaseSpec``'s geometry and
view helpers (repro_torch vs repro).

The same numpy-seeded words, bits and bytes go through both packages; all
of it is integer, so every comparison is exact. Words with bit 31 set
check that the port's int32 shifts are masked.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import PIRConfig as RefPIRConfig
from repro.crypto import packing as ref_packing
from repro.db import DatabaseSpec as RefDatabaseSpec
from repro_torch.config import PIRConfig
from repro_torch.crypto import packing
from repro_torch.db import Database, DatabaseSpec

N = 1 << 8


def _u(t):
    return t.numpy().view(np.uint32)


def _words(shape, seed):
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                             dtype=np.uint32)
    w.reshape(-1)[0] = 0x80000001         # a word with bit 31 set
    return w


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
def test_bytes_to_words_matches_reference(k):
    b = np.random.default_rng(k).integers(0, 256, size=(3, 4 * k),
                                          dtype=np.uint8)
    b[0, 3] = 0xFF                        # a top byte >= 128
    want = np.asarray(ref_packing.bytes_to_words(jnp.asarray(b)))
    np.testing.assert_array_equal(_u(packing.bytes_to_words(
        torch.from_numpy(b))), want)
    # int8 bytes pack by their bits
    np.testing.assert_array_equal(_u(packing.bytes_to_words(
        torch.from_numpy(b.view(np.int8)))), want)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_words_bytes_round_trip(k):
    w = _words((3, k), k)
    t = torch.from_numpy(w.view(np.int32))
    b = packing.words_to_bytes(t)
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(ref_packing.words_to_bytes(jnp.asarray(w))))
    assert torch.equal(packing.bytes_to_words(b), t)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bits_words_match_reference(k):
    bits = np.random.default_rng(10 + k).integers(0, 2, size=(2, 32 * k),
                                                  dtype=np.uint32)
    bits[0, 31] = 1                       # bit 31 of the first word
    want = np.asarray(ref_packing.pack_bits_to_words(jnp.asarray(bits)))
    got = packing.pack_bits_to_words(torch.from_numpy(bits.view(np.int32)))
    np.testing.assert_array_equal(_u(got), want)
    back = packing.unpack_words_to_bits(got)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(ref_packing.unpack_words_to_bits(jnp.asarray(want))))
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), bits.view(np.int32))


def test_unpack_masks_arithmetic_shifts():
    w = np.array([[0xFFFFFFFF, 0x80000000]], np.uint32)
    got = packing.unpack_words_to_bits(torch.from_numpy(w.view(np.int32)))
    want = np.asarray(ref_packing.unpack_words_to_bits(jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(got.numpy())) <= {0, 1}


@pytest.mark.parametrize("fn,shape,match", [
    ("bytes_to_words", (3,), "multiple of 4"),
    ("bytes_to_words", (2, 6), "multiple of 4"),
    ("pack_bits_to_words", (31,), "multiple of 32"),
    ("pack_bits_to_words", (2, 40), "multiple of 32")])
def test_packing_rejects_bad_sizes(fn, shape, match):
    for mod, zeros in ((ref_packing, jnp.zeros(shape, jnp.uint8)),
                       (packing, torch.zeros(shape, dtype=torch.uint8))):
        with pytest.raises(ValueError, match=match):
            getattr(mod, fn)(zeros)


# ---------------------------------------------------------------------------
# DatabaseSpec
# ---------------------------------------------------------------------------

def _specs(**kw):
    cfg = PIRConfig(n_items=N, **kw)
    return (DatabaseSpec.from_config(cfg),
            RefDatabaseSpec.from_config(RefPIRConfig(**cfg.to_dict())))


@pytest.mark.parametrize("item_bytes,checksum", [(32, False), (36, True),
                                                 (4, False)])
def test_spec_geometry_matches_reference(item_bytes, checksum):
    spec, ref = _specs(item_bytes=item_bytes, checksum=checksum)
    assert (spec.log_n, spec.db_bytes) == (ref.log_n, ref.db_bytes)
    for shards in (1, 2, 4, 0):
        assert spec.rows_per_shard(shards) == ref.rows_per_shard(shards)
    for bad, match in ((3, "divisible"), (N * 2, "divisible")):
        for s in (spec, ref):
            with pytest.raises(ValueError, match=match):
                s.rows_per_shard(bad)


def test_rows_per_shard_power_of_two_error():
    # a power-of-two N never leaves a quotient that is not one, so both
    # specs get 12 rows past their constructor's check
    for s in _specs():
        object.__setattr__(s, "n_items", 12)
        assert s.rows_per_shard(3) == 4
        with pytest.raises(ValueError, match="power of two, got 3"):
            s.rows_per_shard(4)
    with pytest.raises(ValueError, match="power of two"):
        DatabaseSpec(n_items=N + 1)


@pytest.mark.parametrize("view", ["words", "bytes", "bytes32"])
@pytest.mark.parametrize("checksum", [False, True])
def test_view_struct_matches_reference(view, checksum):
    spec, ref = _specs(checksum=checksum)
    got, want = spec.view_struct(view), ref.view_struct(view)
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    # u32 words travel in int32; the bytes views keep their dtype
    want_dtype = {np.dtype(np.uint32): torch.int32,
                  np.dtype(np.int8): torch.int8,
                  np.dtype(np.int32): torch.int32}[np.dtype(want.dtype)]
    assert got.dtype == want_dtype
    with pytest.raises(KeyError, match="unknown db view"):
        spec.view_struct("float16")


def test_host_helpers_match_reference():
    spec, ref = _specs()
    w = _words((N, 8), 3)
    b = spec.words_to_bytes_host(w)
    np.testing.assert_array_equal(b, ref.words_to_bytes_host(w))
    np.testing.assert_array_equal(spec.bytes_to_words_host(b),
                                  ref.bytes_to_words_host(b))
    np.testing.assert_array_equal(spec.bytes_to_words_host(b), w)
    for view in ("words", "bytes", "bytes32"):
        got, want = spec.pack_host(w, view), ref.pack_host(w, view)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for s in (spec, ref):
        with pytest.raises(KeyError, match="unknown db view"):
            s.pack_host(w, "float16")


@pytest.mark.parametrize("view", ["words", "bytes", "bytes32"])
def test_device_helpers_match_reference(view):
    spec, ref = _specs()
    w = _words((N, 8), 4)
    t = torch.from_numpy(w.view(np.int32))
    got = spec.words_to_view_device(view, t)
    want = np.asarray(ref.words_to_view_device(view, jnp.asarray(w)))
    if view == "words":
        np.testing.assert_array_equal(_u(got), want)
    else:
        assert got.dtype == {"bytes": torch.int8,
                             "bytes32": torch.int32}[view]
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(KeyError, match="unknown db view"):
        spec.words_to_view_device("float16", t)


def test_device_bytes_are_a_view_of_the_words():
    spec, ref = _specs()
    w = _words((N, 8), 5)
    t = torch.from_numpy(w.view(np.int32))
    b = spec.words_to_bytes_device(t)
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(ref.words_to_bytes_device(jnp.asarray(w))))
    assert b.data_ptr() == t.data_ptr()                  # no copy
    assert spec.words_to_view_device("bytes", t).data_ptr() == t.data_ptr()


def test_database_views_come_from_the_spec():
    cfg = PIRConfig(n_items=N)
    w = _words((N, 8), 6)
    db = Database(w, cfg, "cpu")
    spec = DatabaseSpec.from_config(cfg)
    words = db.view("words")
    assert db.view("bytes").data_ptr() == words.data_ptr()
    for view in ("bytes", "bytes32"):
        assert torch.equal(db.view(view),
                           spec.words_to_view_device(view, words))
    # a publish derives the new rows' bytes32 through the same helper
    rows = np.array([1, 7])
    vals = _words((2, 8), 7)
    db.stage(rows, vals)
    db.publish()
    w[rows] = vals
    np.testing.assert_array_equal(db.view("bytes32").numpy(),
                                  spec.pack_host(w, "bytes32"))
    np.testing.assert_array_equal(db.view("bytes").numpy(),
                                  spec.pack_host(w, "bytes"))
