"""Port parity: verified reconstruction (the per-row checksum column) and
records wider than 32 bytes, repro_torch vs repro.

``row_checksum``, ``verify_records`` in both record forms (with equal
``bad_queries``), ``attach_checksums`` / ``verify_stored_rows``, the
``make_database(checksum=True)`` layout and the plan cache's ``"+c"``
signature are held against the reference's functions on the same seeded
inputs. Then XOR, additive, k = 3 and LWE verified reconstruction through
the port's facades on the CPU, at ``PIR_SMOKE`` with ``checksum=True``,
``PIR_SMOKE_CHK`` and ``xor-dpf-k``: the port's answers go through both
packages' ``reconstruct_with``, whose records must be equal, and a
corrupted share must raise ``IntegrityError`` on both sides with equal
``bad_queries``, and a served batch with a corrupted share fails the
same futures as the reference's ``MultiServerPIR`` (a session dies with
every outstanding future; ``pump`` fails the batches it launched); an LWE
answer shifted by Delta passes the noise check and the checksum catches
it. Last, the private embedding lookup of
``tests/test_system.py`` (128-byte bf16 rows) served by the port. Exact
equality throughout.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import PIRConfig as RefPIRConfig
from repro.configs import pir as ref_configs
from repro.core import pir as ref_pir
from repro.core.protocol import for_config as ref_for_config
from repro.db import DatabaseSpec as RefDatabaseSpec
from repro.db import IntegrityError as RefIntegrityError
from repro.db import row_checksum as ref_row_checksum
from repro.db import verify_records as ref_verify_records
from repro.engine.cache import spec_signature as ref_spec_signature
from repro.launch.mesh import make_local_mesh
from repro.runtime.serve_loop import MultiServerPIR as RefMultiServerPIR
from repro_torch.config import PIRConfig
from repro_torch.configs import pir as configs
from repro_torch.core import lwe, pir
from repro_torch.core.protocol import for_config
from repro_torch.crypto.packing import (np_words_to_bytes, records_to_host,
                                        tensor_to_words)
from repro_torch.db import (Database, DatabaseSpec, IntegrityError,
                            row_checksum, verify_records)
from repro_torch.engine.cache import spec_signature
from repro_torch.runtime.serve_loop import (MultiServerPIR, SingleServerPIR,
                                            TwoServerPIR)


def _ref_cfg(cfg: PIRConfig) -> RefPIRConfig:
    return RefPIRConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# row_checksum, verify_records, the stored widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 8), (5, 2), (7, 1), (2, 3, 32)])
def test_row_checksum_matches_reference(shape):
    w = np.random.default_rng(len(shape) + shape[-1]).integers(
        0, 1 << 32, size=shape, dtype=np.uint32)
    got = row_checksum(w)
    assert got.dtype == np.uint32 and got.shape == shape[:-1]
    np.testing.assert_array_equal(got, ref_row_checksum(w))


def test_row_checksum_sensitivity_and_determinism():
    w = np.random.default_rng(0).integers(0, 1 << 32, size=(64, 8),
                                          dtype=np.uint32)
    c1 = row_checksum(w)
    np.testing.assert_array_equal(c1, row_checksum(w))
    w2 = w.copy()
    w2[10, 3] ^= np.uint32(1)
    c2 = row_checksum(w2)
    assert c2[10] != c1[10]
    np.testing.assert_array_equal(np.delete(c2, 10), np.delete(c1, 10))
    w3 = w.copy()
    w3[0] = w[0][::-1]
    assert row_checksum(w3)[0] != c1[0]
    with pytest.raises(ValueError, match="payload word"):
        row_checksum(np.zeros((3, 0), np.uint32))


@pytest.mark.parametrize("form", ["words", "bytes"])
def test_verify_records_both_forms_match_reference(form):
    rng = np.random.default_rng(2)
    w = rng.integers(0, 1 << 32, size=(6, 2), dtype=np.uint32)
    spec = DatabaseSpec(n_items=8, item_bytes=8, checksum=True)
    stored = spec.attach_checksums(w)
    np.testing.assert_array_equal(
        stored, RefDatabaseSpec(n_items=8, item_bytes=8,
                                checksum=True).attach_checksums(w))
    as_form = (lambda x: x) if form == "words" else np_words_to_bytes
    good = verify_records(as_form(stored), 8)
    np.testing.assert_array_equal(good, ref_verify_records(as_form(stored),
                                                           8))
    np.testing.assert_array_equal(good, as_form(w))
    bad = stored.copy()
    bad[0, 1] ^= np.uint32(2)
    bad[4, 2] ^= np.uint32(1 << 31)          # the checksum word itself
    with pytest.raises(IntegrityError) as got:
        verify_records(as_form(bad), 8)
    with pytest.raises(RefIntegrityError) as want:
        ref_verify_records(as_form(bad), 8)
    assert got.value.bad_queries == want.value.bad_queries == (0, 4)
    with pytest.raises(ValueError):
        verify_records(np.zeros((2, 7), np.uint8), 8)


def test_spec_stored_widths_and_idempotent_attach():
    spec = DatabaseSpec(n_items=8, item_bytes=8, checksum=True)
    ref = RefDatabaseSpec(n_items=8, item_bytes=8, checksum=True)
    assert (spec.stored_words, spec.stored_bytes) == \
        (ref.stored_words, ref.stored_bytes) == (3, 12)
    for view in ("words", "bytes", "bytes32"):
        assert spec.view_shape(view) == ref.view_shape(view)
    w = np.arange(16, dtype=np.uint32).reshape(8, 2)
    st1 = spec.attach_checksums(w)
    np.testing.assert_array_equal(spec.attach_checksums(st1), st1)
    np.testing.assert_array_equal(spec.verify_stored_rows(st1), w)
    bad = st1.copy()
    bad[3, 0] ^= np.uint32(4)
    with pytest.raises(IntegrityError) as got:
        spec.verify_stored_rows(bad)
    with pytest.raises(RefIntegrityError) as want:
        ref.verify_stored_rows(bad)
    assert got.value.bad_queries == want.value.bad_queries == (3,)
    with pytest.raises(ValueError, match="payload rows"):
        spec.attach_checksums(np.zeros((2, 5), np.uint32))
    off = DatabaseSpec(n_items=8, item_bytes=8)
    assert (off.stored_words, off.stored_bytes) == (2, 8)
    np.testing.assert_array_equal(off.attach_checksums(w), w)
    np.testing.assert_array_equal(off.verify_stored_rows(w), w)


def test_make_database_checksum_layout_matches_reference():
    db = pir.make_database(np.random.default_rng(0), 8, 8, checksum=True)
    assert db.shape == (8, 3)
    np.testing.assert_array_equal(
        db, ref_pir.make_database(np.random.default_rng(0), 8, 8,
                                  checksum=True))
    np.testing.assert_array_equal(db[:, 2], row_checksum(db[:, :2]))
    np.testing.assert_array_equal(
        db[:, :2], pir.make_database(np.random.default_rng(0), 8, 8))


@pytest.mark.parametrize("checksum", [False, True])
def test_plan_cache_signature_marks_checksums_as_the_reference(checksum):
    cfg = PIRConfig(n_items=1 << 12, item_bytes=32, checksum=checksum)
    assert spec_signature(cfg) == ref_spec_signature(_ref_cfg(cfg))
    assert spec_signature(cfg).endswith("+c") == checksum


def test_checksum_config_matches_reference():
    assert dataclasses.asdict(configs.PIR_SMOKE_CHK) == \
        dataclasses.asdict(ref_configs.PIR_SMOKE_CHK)
    assert configs.PIR_CONFIGS["pir-smoke-chk"] is configs.PIR_SMOKE_CHK


def test_database_attaches_the_column_once():
    cfg = dataclasses.replace(configs.PIR_SMOKE, n_items=64, checksum=True)
    host = pir.make_database(np.random.default_rng(1), 64, 32)
    database = Database(host, cfg, "cpu")
    stored = tensor_to_words(database.view("words"))
    assert stored.shape == (64, 9)
    np.testing.assert_array_equal(stored[:, :8], host)
    np.testing.assert_array_equal(stored[:, 8], row_checksum(host))
    # rows already at the stored width pass through as they are
    again = Database(stored, cfg, "cpu")
    assert torch.equal(again.view(), database.view())
    # the byte view still aliases the words, at the stored width
    assert database.view("bytes").shape == (64, 36)
    assert database.view("bytes").data_ptr() == database.view().data_ptr()
    assert database.view("bytes32").shape == (64, 36)


# ---------------------------------------------------------------------------
# Verified reconstruction through the facades, both packages
# ---------------------------------------------------------------------------

CHK_DPF = {
    "xor-dpf-2": dataclasses.replace(configs.PIR_SMOKE, checksum=True),
    "additive-dpf-2": dataclasses.replace(configs.PIR_SMOKE_ADD,
                                          checksum=True),
    "xor-dpf-k": dataclasses.replace(configs.PIR_SMOKE_K3, checksum=True),
}


@pytest.fixture(scope="module", params=sorted(CHK_DPF))
def dpf_system(request):
    cfg = CHK_DPF[request.param]
    host = pir.make_database(np.random.default_rng(71), cfg.n_items,
                             cfg.item_bytes)
    system = MultiServerPIR(host, cfg, device="cpu", n_queries=4,
                            client_rng=np.random.default_rng(72))
    return cfg, host, system


def _expected(system, host, idx):
    rows = host[np.asarray(idx)]
    _, dtype = system.protocol.record_struct(system.cfg)
    return np_words_to_bytes(rows) if dtype == np.uint8 else rows


def _dpf_answers(system, idx, seed):
    keys = system.protocol.query_gen_batch(np.random.default_rng(seed), idx,
                                           system.cfg)
    return [s.answer(k) for s, k in zip(system.servers, keys)]


def _ref_answers(answers, cfg):
    """The port's answer tensors as the reference's arrays: u32 words for
    the XOR schemes, int32 for the additive one."""
    xor = for_config(cfg).share_kind == "xor"
    return [jnp.asarray(a.numpy().view(np.uint32) if xor else a.numpy())
            for a in answers]


def test_dpf_verified_records_match_reference(dpf_system):
    cfg, host, system = dpf_system
    idx = [0, 17, 4000, cfg.n_items - 1]
    got = system.query(idx)
    np.testing.assert_array_equal(got, _expected(system, host, idx))
    assert got.shape[1] == system.protocol.record_struct(cfg)[0][0]
    answers = _dpf_answers(system, idx, 73)
    assert answers[0].shape[1] == system.db.view(
        system.protocol.db_view).shape[1]            # the stored width
    mine = system.protocol.reconstruct_with(answers, [None] * 4, cfg=cfg)
    theirs = np.asarray(ref_for_config(_ref_cfg(cfg)).reconstruct_with(
        _ref_answers(answers, cfg), [None] * 4, cfg=_ref_cfg(cfg)))
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(mine, _expected(system, host, idx))


@pytest.mark.parametrize("bad", [[1], [0, 3]])
def test_dpf_corrupted_share_raises_on_both_sides(dpf_system, bad):
    cfg, _, system = dpf_system
    answers = _dpf_answers(system, [5, 6, 7, 8], 74 + len(bad))
    party = len(answers) - 1
    answers[party] = answers[party].clone()
    for i in bad:
        answers[party][i, 2] ^= 0x5A
    with pytest.raises(IntegrityError) as got:
        system.protocol.reconstruct_with(answers, [None] * 4, cfg=cfg)
    with pytest.raises(RefIntegrityError) as want:
        ref_for_config(_ref_cfg(cfg)).reconstruct_with(
            _ref_answers(answers, cfg), [None] * 4, cfg=_ref_cfg(cfg))
    assert got.value.bad_queries == want.value.bad_queries == tuple(bad)


def _corrupt_first_dispatch(sched, flip):
    """Wrap ``sched._dispatch`` so that the first batch's party-0 share has
    query 2's first word flipped (``flip`` edits one answer array);
    returns the restore callable."""
    orig, calls = sched._dispatch, []

    def corrupt(staged):
        answers, epoch = orig(staged)
        calls.append(1)
        if len(calls) == 1:
            answers = (flip(answers[0]),) + tuple(answers[1:])
        return answers, epoch

    sched._dispatch = corrupt
    return lambda: setattr(sched, "_dispatch", orig)


def _flip_port(a):
    a = a.clone()
    a[2, 0] ^= 1
    return a


def _flip_ref(a):
    return a.at[2, 0].set(a[2, 0] ^ 1)


def _outcome(fut, timeout=120.0):
    """``(exception class name, bad_queries, exception)`` of a failed
    future, ``("ok", None, None)`` of an answered one."""
    try:
        fut.result(timeout=timeout)
    except Exception as e:          # noqa: BLE001 - the outcome is the point
        return type(e).__name__, getattr(e, "bad_queries", None), e
    return "ok", None, None


def _session_outcomes(system, flip):
    """Session mode: a batch of 4 with a corrupted share and a batch of 2
    behind it, submitted before the session starts. Returns the futures'
    outcomes, whether submit raised once the session died, and the records
    of a fresh batch after ``start()`` reopened it."""
    sched = system.scheduler
    restore = _corrupt_first_dispatch(sched, flip)
    try:
        futs = [system.submit(i) for i in (3, 4, 5, 6, 7, 8)]
        sched.start()
        outcomes = [_outcome(f) for f in futs]
        deadline = time.monotonic() + 60.0
        while sched.running and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="stop"):
            system.submit(9)
    finally:
        restore()
    sched.start()
    try:
        fresh = system.query([3, 4, 5])
    finally:
        system.close()
    return outcomes, fresh


def _pump_outcomes(system, flip):
    """``pump`` mode: batches of 4 (corrupted), 4 and 1; depth 2 launches
    the first two before the first fails. Returns the futures of each
    batch and the error ``pump`` raised."""
    sched = system.scheduler
    restore = _corrupt_first_dispatch(sched, flip)
    try:
        futs = [system.submit(i) for i in (3, 4, 5, 6, 7, 8, 10, 11, 9)]
        with pytest.raises(Exception) as raised:
            sched.pump()
    finally:
        restore()
    return futs[:4], futs[4:8], futs[8:], raised.value


def test_served_batch_with_a_corrupted_share_fails_every_outstanding_future(
        dpf_system):
    """A flipped share in a served batch raises IntegrityError out of its
    finalize, as the reference's does. In a session that kills the
    session: every outstanding future fails with the same exception
    (``bad_queries`` naming the flipped query of the corrupted batch),
    exactly as the reference's ``MultiServerPIR`` fails them; submit raises
    until ``start()`` reopens the session, and then a fresh batch is exact.
    In ``pump`` mode the corrupted batch's futures fail as the reference's
    do, and the batch launched behind it fails with the same exception
    (the reference leaves it unresolved); the batch not yet launched stays
    queued for the next pump."""
    cfg, host, _ = dpf_system
    system = MultiServerPIR(host, cfg, device="cpu", n_queries=4,
                            client_rng=np.random.default_rng(75))
    ref = RefMultiServerPIR(host, _ref_cfg(cfg), make_local_mesh(),
                            path="fused", n_queries=4, buckets=(4,),
                            client_rng=np.random.default_rng(75))

    first, second, third, err = _pump_outcomes(system, _flip_port)
    r_first, r_second, r_third, r_err = _pump_outcomes(ref, _flip_ref)
    assert (type(err).__name__, err.bad_queries) \
        == (type(r_err).__name__, r_err.bad_queries) \
        == ("IntegrityError", (2,))
    assert [_outcome(f, 0)[:2] for f in first] \
        == [_outcome(f, 0)[:2] for f in r_first]
    assert all(f.exception() is err for f in first + second)
    assert not any(f.done() for f in r_second)          # the reference's hang
    assert not any(f.done() for f in third + r_third)   # still queued
    assert system.scheduler.queue_depth == 1
    system.scheduler.pump()
    ref.scheduler.pump()
    np.testing.assert_array_equal(third[0].result(0),
                                  _expected(system, host, [9])[0])
    np.testing.assert_array_equal(r_third[0].result(0), third[0].result(0))
    assert system.scheduler.queue_depth == 0

    mine, fresh = _session_outcomes(system, _flip_port)
    theirs, ref_fresh = _session_outcomes(ref, _flip_ref)
    assert [o[:2] for o in mine] == [o[:2] for o in theirs] \
        == [("IntegrityError", (2,))] * 6
    assert all(o[2] is mine[0][2] for o in mine)        # one exception
    assert all(o[2] is theirs[0][2] for o in theirs)
    np.testing.assert_array_equal(fresh, _expected(system, host, [3, 4, 5]))
    np.testing.assert_array_equal(ref_fresh, fresh)


@pytest.fixture(scope="module")
def lwe_system():
    cfg = configs.PIR_SMOKE_CHK
    host = pir.make_database(np.random.default_rng(81), cfg.n_items,
                             cfg.item_bytes)
    system = SingleServerPIR(host, cfg, device="cpu", n_queries=4,
                             client_rng=np.random.default_rng(82))
    return cfg, host, system


def _lwe_answers(system, idx, seed):
    (ct,), states = system.protocol.query_gen_batch_full(
        np.random.default_rng(seed), idx, system.cfg, device="cpu")
    return system.servers[0].answer(ct), states


def test_lwe_verified_records_match_reference(lwe_system):
    cfg, host, system = lwe_system
    idx = [0, 9, 4095]
    np.testing.assert_array_equal(system.query(idx),
                                  np_words_to_bytes(host[idx]))
    ans, states = _lwe_answers(system, idx, 83)
    hint = system.db.hint(system.protocol.name).numpy()
    assert hint.shape == (lwe.params_for(cfg.n_items).n, 36)
    mine = system.protocol.reconstruct_with([ans], states, cfg=cfg,
                                            hint=hint)
    theirs = np.asarray(ref_for_config(_ref_cfg(cfg)).reconstruct_with(
        [ans.numpy()], states, cfg=_ref_cfg(cfg), hint=hint))
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(mine, np_words_to_bytes(host[idx]))


@pytest.mark.parametrize("bad,col", [(0, 3), (2, 34)])
def test_lwe_delta_shift_raises_on_both_sides(lwe_system, bad, col):
    """An answer shifted by Delta decodes to a clean plaintext shift the
    noise check cannot see: the checksum names it (a payload byte, or a
    byte of the checksum word). Without the column the same shift is a
    silently wrong record."""
    cfg, host, system = lwe_system
    idx = [1, 2, 3]
    ans, states = _lwe_answers(system, idx, 84 + bad)
    ans = ans.clone()
    ans[bad, col] += lwe.params_for(cfg.n_items).delta
    hint = system.db.hint(system.protocol.name).numpy()
    with pytest.raises(IntegrityError) as got:
        system.protocol.reconstruct_with([ans], states, cfg=cfg, hint=hint)
    with pytest.raises(RefIntegrityError) as want:
        ref_for_config(_ref_cfg(cfg)).reconstruct_with(
            [ans.numpy()], states, cfg=_ref_cfg(cfg), hint=hint)
    assert got.value.bad_queries == want.value.bad_queries == (bad,)
    assert "checksum" in str(got.value)
    # the stored layout read as a checksum-less 36-byte database
    cfg0 = dataclasses.replace(cfg, item_bytes=36, checksum=False)
    rec0 = for_config(cfg0).reconstruct_with([ans], states, cfg=cfg0,
                                             hint=hint)
    stored = np_words_to_bytes(system.db.spec.attach_checksums(host))[idx]
    assert not np.array_equal(rec0[bad], stored[bad])
    np.testing.assert_array_equal(np.delete(rec0, bad, 0),
                                  np.delete(stored, bad, 0))


def test_lwe_gross_corruption_trips_the_noise_check_first(lwe_system):
    cfg, _, system = lwe_system
    ans, states = _lwe_answers(system, [4, 5], 86)
    ans = ans.clone()
    ans[0, 0] ^= int(np.int32(np.uint32(0x80808080).view(np.int32)))
    hint = system.db.hint(system.protocol.name).numpy()
    with pytest.raises(IntegrityError, match="noise overflow"):
        system.protocol.reconstruct_with([ans], states, cfg=cfg, hint=hint)
    with pytest.raises(RefIntegrityError, match="noise overflow"):
        ref_for_config(_ref_cfg(cfg)).reconstruct_with(
            [ans.numpy()], states, cfg=_ref_cfg(cfg), hint=hint)


# ---------------------------------------------------------------------------
# 128-byte records: the private embedding lookup (tests/test_system.py)
# ---------------------------------------------------------------------------

def test_private_embedding_lookup():
    """PIR over an embedding table of bf16 rows, 128 bytes each: the rows
    are viewed as u32 words (pairs of bf16), retrieved for hidden token ids
    through the port's TwoServerPIR on its fused path, and come back bit
    for bit."""
    vocab_pow2, d = 1 << 10, 64
    rng = np.random.default_rng(3)
    table_bf16 = torch.from_numpy(rng.standard_normal((vocab_pow2, d))
                                  ).to(torch.bfloat16)
    table_u16 = table_bf16.view(torch.int16).numpy().view(np.uint16)
    table_words = ((table_u16[:, 1::2].astype(np.uint32) << 16)
                   | table_u16[:, 0::2])
    cfg = PIRConfig(n_items=vocab_pow2, item_bytes=d * 2, batch_queries=2)
    system = TwoServerPIR(table_words, cfg, device="cpu", path="fused",
                          n_queries=2, client_rng=np.random.default_rng(4))
    token_ids = [17, 513]
    rows = system.query(token_ids)                       # [2, d/2] uint32
    out = np.empty((2, d), np.uint16)
    out[:, 0::2] = (rows & 0xFFFF).astype(np.uint16)
    out[:, 1::2] = (rows >> 16).astype(np.uint16)
    np.testing.assert_array_equal(out, table_u16[token_ids])


@pytest.mark.parametrize("protocol", ["xor-dpf-2", "additive-dpf-2"])
def test_128_byte_records_match_reference(protocol):
    """128-byte records served by the port equal the reference's
    reconstruction of the same answers, on both DPF schemes."""
    cfg = PIRConfig(n_items=1 << 8, item_bytes=128, protocol=protocol,
                    batch_queries=4)
    host = pir.make_database(np.random.default_rng(91), cfg.n_items, 128)
    system = TwoServerPIR(host, cfg, device="cpu", n_queries=4,
                          client_rng=np.random.default_rng(92))
    idx = [0, 77, 255]
    np.testing.assert_array_equal(system.query(idx),
                                  _expected(system, host, idx))
    answers = _dpf_answers(system, idx, 93)
    theirs = np.asarray(ref_for_config(_ref_cfg(cfg)).reconstruct_with(
        _ref_answers(answers, cfg), [None] * 3, cfg=_ref_cfg(cfg)))
    mine = system.protocol.reconstruct_with(answers, [None] * 3, cfg=cfg)
    np.testing.assert_array_equal(records_to_host(mine), theirs)
