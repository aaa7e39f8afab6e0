"""Port: the hybrid family's serve step and private-embedding twin
(zamba2-7b ``SMOKE``) against the reference on the CPU — the step inputs
at every shape, ``make_serve_step``'s prefill and decode against the
reference model's, and the twin: every token's row through
``TwoServerPIR`` over the padded ``embed`` table.

Tolerances are ``tests/test_torch_zamba2_model.py``'s, whose pairs of
models (the reference's weights from ``PRNGKey(0)`` converted into the
port's) these tests share. The twin's rows are bit-exact and its tokens
those of the same loop on plain lookups. torch is pinned to one thread.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models.registry import input_specs as ref_input_specs
from repro_torch import private_inference as pi
from repro_torch.configs import SMOKES, get_arch
from repro_torch.configs.shapes import SHAPES, SMOKE_PREFILL
from repro_torch.models import build_model, input_specs
from repro_torch.runtime.steps import make_serve_step

from test_torch_zamba2_model import (ARCH, DTYPES, cache_close,
                                     logits_close, pad_cache, pair,
                                     tokens_for)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the serve step and the twin ----------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES) + ["smoke_prefill"])
def test_input_specs_match_the_reference(shape):
    """Tokens only, at every shape: ``[B, S]``, ``[B, 1]`` for a decode
    shape (long_500k's included)."""
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro.configs.shapes import SMOKE_PREFILL as REF_SMOKE_PREFILL
    port_shape = SMOKE_PREFILL if shape == "smoke_prefill" else SHAPES[shape]
    ref_shape = (REF_SMOKE_PREFILL if shape == "smoke_prefill"
                 else REF_SHAPES[shape])
    got = input_specs(get_arch(ARCH), port_shape)
    want, _ = ref_input_specs(REF_SMOKES[ARCH], ref_shape)
    assert {k: (s.shape, str(s.dtype).split(".")[-1])
            for k, s in got.items()} == \
        {k: (s.shape, str(s.dtype)) for k, s in want.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_make_serve_step_on_zamba2(dtype):
    """make_serve_step at SMOKE: the prefill takes ``tokens`` alone with a
    capacity, refuses a side input; a decode with ``decode_write``
    appends to the KV caches; both against the reference model's."""
    _, params, port, _, pre, dec = pair(dtype)
    ss = make_serve_step(port.cfg, SMOKE_PREFILL, device="cpu",
                         decode_write=True,
                         capacity=SMOKE_PREFILL.seq_len + 1)
    ss.model.load_state_dict(port.state_dict())
    tok = tokens_for(SMOKE_PREFILL.seq_len + 1, seed=2)
    logits, cache = ss.prefill(
        {"tokens": torch.from_numpy(tok[:, :-1]).long()})
    want, rc = pre(params, tok[:, :-1])
    logits_close(logits, want, dtype)
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        ss.prefill({"tokens": torch.from_numpy(tok[:, :-1]).long(),
                    "prefix_embeds": torch.zeros(1)})
    logits, cache = ss.decode(cache, torch.from_numpy(tok[:, -1:]).long())
    want, rc = dec[True](params, pad_cache(rc, 1), tok[:, -1:])
    logits_close(logits, want, dtype)
    cache_close(cache, rc, dtype)
    assert int(cache.length) == SMOKE_PREFILL.seq_len + 1


@pytest.mark.parametrize("streams,tokens", [(2, 4), (4, 3)])
def test_twin_on_zamba2_smoke(streams, tokens):
    """zamba2 SMOKE on the CPU: every token's row through TwoServerPIR
    bit-exact over the 2^9-row table of ``embed`` (the input table, not
    the untied ``unembed``), the tokens equal the plain-lookup loop's, no
    side input, and the queries are the prompt's, one per stream per
    further token, one alone (the solo step on a stream's slice of the
    hybrid cache)."""
    out = pi.run(device="cpu", arch=ARCH, smoke=True, tokens=tokens,
                 streams=streams, seed=5, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert out["prefix_rows"] == 0 and pi.side_input(SMOKES[ARCH]) is None
    assert [c["queries"] for c in out["pir_calls"]] == \
        [3 * streams] + [streams] * (tokens - 1) + [1]
    assert np.asarray(out["streams"]).shape == (streams, 3 + tokens)
    assert pi.padded_rows(SMOKES[ARCH].vocab) == 1 << 9
    assert pi.padded_rows(get_arch(ARCH).vocab) == 1 << 15


def test_twin_fetches_the_input_table():
    """The servers' table is ``embed``'s rows, padded, and never
    ``unembed``'s."""
    model = build_model(SMOKES[ARCH], device="cpu").init_params(
        torch.Generator().manual_seed(6))
    table = pi.padded_table(model)
    assert torch.equal(table[:model.embed.shape[0]], model.embed)
    assert not torch.equal(table[:model.embed.shape[0]], model.unembed)
    assert not table[model.embed.shape[0]:].any()


def test_twin_cli_on_zamba2_smoke(capsys):
    pi.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--tokens", "2",
             "--streams", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "zamba2-7b-smoke"
    assert summary["rows_exact"] and summary["plain_equal"]
    assert summary["queries"] == 6 + 2 + 1
