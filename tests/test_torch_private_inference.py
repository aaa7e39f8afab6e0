"""Port: the private-embedding LM twin (``repro_torch.private_inference``)
against ``examples/private_inference.py`` and ``tests/test_system.py``'s
lookup, on the CPU.

The table's bf16 rows viewed as 32-bit words on a tensor are the
reference's ``table_as_words`` bit for bit; the lookup retrieves the same
rows through both packages' ``TwoServerPIR``; and with the example's
parameters converted, the twin generates the example's streams, though it
decodes with a KV cache where the example recomputes the trunk each step.
"""
import importlib.util
import json
import pathlib
import re
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as RefModelConfig
from repro.config import PIRConfig as RefPIRConfig
from repro.launch.mesh import make_local_mesh
from repro.models import build_model as ref_build
from repro.runtime.serve_loop import TwoServerPIR as RefTwoServerPIR
from repro_torch import private_inference as pi
from repro_torch.config import PIRConfig
from repro_torch.convert import model_params_from_reference
from repro_torch.db import Database
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import TwoServerPIR

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def example():
    """``examples/private_inference.py`` as a module (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "private_inference_example",
        ROOT / "examples" / "private_inference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_table(rng, rows: int, d: int, *, any_bits: bool) -> np.ndarray:
    """``[rows, d]`` numpy bf16: every 16-bit pattern (NaNs, infinities,
    signed zeros) when ``any_bits``, else normal draws rounded."""
    if any_bits:
        return rng.integers(0, 1 << 16, (rows, d), dtype=np.uint16).view(
            jnp.bfloat16.dtype)
    return np.asarray(jnp.asarray(rng.standard_normal((rows, d)),
                                  jnp.bfloat16))


def as_tensor(table_np: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(table_np.view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("any_bits", [True, False])
@pytest.mark.parametrize("rows,d", [(7, 2), (300, 64), (16, 2560)])
def test_table_as_words_is_the_reference_packing(example, rows, d, any_bits):
    table = bf16_table(np.random.default_rng(rows + d), rows, d,
                       any_bits=any_bits)
    want = example.table_as_words(table)                 # [V, d/2] uint32
    got = pi.table_as_words(as_tensor(table))
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = pi.words_as_rows(got, d)
    np.testing.assert_array_equal(back.view(torch.int16).numpy(),
                                  table.view(np.int16))
    np.testing.assert_array_equal(
        example.words_as_rows(want, d).view(np.uint16),
        back.view(torch.int16).numpy().view(np.uint16))


def test_table_views_refuse_what_they_cannot_view():
    with pytest.raises(ValueError, match="bf16"):
        pi.table_as_words(torch.zeros((4, 3), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bf16"):
        pi.table_as_words(torch.zeros((4, 4), dtype=torch.float32))
    with pytest.raises(ValueError, match="int32"):
        pi.words_as_rows(torch.zeros((4, 2), dtype=torch.int32), 6)


def test_padded_rows():
    assert pi.padded_rows(1 << 10) == 1 << 10
    assert pi.padded_rows(512) == 512
    assert pi.padded_rows(151936) == 1 << 18          # qwen3-4b: 152064 rows
    assert pi.padded_rows(49155) == 1 << 16


def test_private_embedding_lookup_matches_reference():
    """``tests/test_system.py:60`` twinned: a 2^10 x 64 bf16 table served
    as words from a tensor; tokens 17 and 513 retrieved by both packages'
    TwoServerPIR are the table's rows bit for bit."""
    vocab_pow2, d = 1 << 10, 64
    rng = np.random.default_rng(3)
    table_bf16 = np.asarray(jnp.asarray(rng.standard_normal((vocab_pow2, d)),
                                        jnp.bfloat16))
    token_ids = [17, 513]
    ref_cfg = RefPIRConfig(n_items=vocab_pow2, item_bytes=d * 2,
                           batch_queries=2)
    u16 = table_bf16.view(np.uint16).astype(np.uint32)
    ref_words = (u16[:, 1::2] << 16) | u16[:, 0::2]
    ref_rows = RefTwoServerPIR(ref_words, ref_cfg, make_local_mesh(),
                               path="fused", n_queries=2).query(token_ids)

    table = as_tensor(table_bf16)
    words = pi.table_as_words(table)
    cfg = PIRConfig(n_items=vocab_pow2, item_bytes=d * 2, batch_queries=2)
    system = TwoServerPIR(words, cfg, device="cpu", n_queries=2,
                          client_rng=np.random.default_rng(4))
    rows = system.query(token_ids)                       # [2, d/2] uint32
    np.testing.assert_array_equal(rows, ref_rows)
    got = pi.words_as_rows(torch.from_numpy(rows.view(np.int32)), d)
    assert torch.equal(got.view(torch.int16), table[token_ids].view(
        torch.int16))


def test_database_copies_a_words_tensor_on_the_cpu():
    """A words tensor is the database's rows: on the CPU a copy, so the
    caller's later writes leave the live epoch alone (on the card it is
    taken over, ``test_torch_lm_card.py``); a tensor of the wrong shape
    or dtype is refused, and so is any tensor for a checksummed
    database, whose column is computed on the host."""
    cfg = PIRConfig(n_items=64, item_bytes=8)
    words = torch.arange(128, dtype=torch.int32).reshape(64, 2)
    db = Database(words, cfg, "cpu")
    assert db.view("words").data_ptr() != words.data_ptr()
    words[3] = -1
    assert torch.equal(db.view("words"),
                       torch.arange(128, dtype=torch.int32).reshape(64, 2))
    assert db.stats.preload_h2d_bytes == 0 and db.stats.n_full_placements == 1
    with pytest.raises(ValueError, match="int32"):
        Database(words.to(torch.int64), cfg, "cpu")
    with pytest.raises(ValueError, match="numpy array"):
        Database(torch.zeros((64, 3), dtype=torch.int32),
                 PIRConfig(n_items=64, item_bytes=8, checksum=True), "cpu")


def test_check_rows_holds_rows_to_the_model_table():
    """``check_rows`` compares each retrieved row with ``model.embed``
    (zero past its rows), not with the servers' memory: a flipped bit in
    a retrieved row, or in the servers' copy, fails it."""
    cfg = replace(pi.PI_LM, vocab=1100)
    model = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    private = pi.PrivateEmbedding(model,
                                  client_rng=np.random.default_rng(2))
    assert private.pir_cfg.n_items == 2048 > model.embed.shape[0]
    rows = private(torch.tensor([0, 7, 1099, 2047]))
    assert torch.equal(rows[:3], model.embed[[0, 7, 1099]])
    assert not rows[3].view(torch.int16).any()
    assert private.check_rows()
    private.log[0]["words"][1, 0] ^= 1
    assert not private.check_rows()
    private.log.clear()
    private.system.db.view("words")[7, 0] ^= 1       # both servers' rows
    private(torch.tensor([7]))
    assert not private.check_rows()


def _ref_example_model():
    cfg = RefModelConfig(name="pi-lm", family="dense", n_layers=2,
                         d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                         vocab=1 << 10, attn_chunk=16)
    model = ref_build(cfg, remat="none")
    return cfg, model.init_params(jax.random.PRNGKey(0))


def test_twin_generates_the_example_streams(example, capsys):
    """The example at ``--tokens 4 --streams 2`` (reference, PRNGKey(0))
    and the twin with those parameters converted: the same tokens for
    each stream and step, in bf16."""
    ref_cfg, params = _ref_example_model()
    assert pi.PI_LM.to_dict() == ref_cfg.to_dict()
    example.main(["--tokens", "4", "--streams", "2"])
    printed = capsys.readouterr().out
    want = [json.loads(m) for m in re.findall(r"^step \d+: \+(\[.*\])$",
                                               printed, re.M)]
    assert len(want) == 4

    port = build_model(pi.PI_LM, device="cpu")
    port.load_state_dict(model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), pi.PI_LM))
    out = pi.run(device="cpu", model=port, tokens=4, streams=2,
                 verbose=False)
    got = np.asarray(out["streams"])
    np.testing.assert_array_equal(got[:, :3], pi.example_prompt(2))
    np.testing.assert_array_equal(got[:, 3:].T, np.asarray(want))
    assert out["rows_exact"] and out["plain_equal"]


@pytest.mark.parametrize("streams,tokens", [(1, 2), (3, 3)])
def test_twin_checks_and_counts(streams, tokens):
    """Seeded twin on the CPU: rows exact, the plain-lookup loop agrees,
    one lookup call for the prompt, one per further token, one alone."""
    out = pi.run(device="cpu", tokens=tokens, streams=streams, seed=5,
                 verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert [c["queries"] for c in out["pir_calls"]] == \
        [3 * streams] + [streams] * (tokens - 1) + [1]
    assert out["queries"] == 3 * streams + streams * (tokens - 1) + 1
    assert np.asarray(out["streams"]).shape == (streams, 3 + tokens)
    assert out["buckets"] == [1, 2, 4, 8, 16, 32]
    assert out["device"] == "cpu"
    assert [s["lookups"] for s in out["steps"]] == \
        [3 * streams] + [streams] * (tokens - 1)
    again = pi.run(device="cpu", tokens=tokens, streams=streams, seed=5,
                   verbose=False)
    assert again["streams"] == out["streams"]


def test_twin_on_a_smoke_arch_and_refused_families():
    out = pi.run(device="cpu", arch="qwen3-4b", smoke=True, tokens=2,
                 streams=2, prompt=np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]]),
                 verbose=False)
    assert out["arch"] == "qwen3-4b-smoke" and out["plain_equal"]
    assert out["pir_calls"][0]["queries"] == 8
    with pytest.raises(KeyError, match="unknown arch"):
        pi.run(device="cpu", arch="no-such-arch", verbose=False)


def test_twin_cli_prints_a_json_summary(capsys):
    pi.main(["--device", "cpu", "--tokens", "2", "--streams", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(last)
    assert summary["twin"] == "private_inference"
    assert summary["rows_exact"] and summary["plain_equal"]
    assert summary["queries"] == 6 + 2 + 1
