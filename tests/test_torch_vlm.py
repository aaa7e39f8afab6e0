"""Port: the VLM family's serving path (llava-next-34b) against the
reference on the CPU — the config, ``input_specs``, ``prefix_embeds``
through ``forward`` / ``prefill`` / ``decode`` and the serve step, and the
private-embedding twin with a client-side image prefix.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; the text tokens and the prefix
(float32, cast to the model's dtype inside each package) come from numpy
seeds. Tolerances are ``tests/test_torch_models.py``'s: float32 logits and
caches atol 1e-4; bfloat16 logits atol = rtol = 2e-2, bf16 caches atol
6e-2 with rtol 2^-6. The twin's rows are bit-exact and its tokens equal
those of the same loop on plain lookups.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.configs import get_arch as ref_get_arch
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import SMOKE_TRAIN as REF_SMOKE_TRAIN
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import build_model as ref_build
from repro.models.registry import input_specs as ref_input_specs
from repro_torch import private_inference as pi
from repro_torch.config import ShapeConfig
from repro_torch.configs import SMOKES, get_arch
from repro_torch.configs.shapes import SHAPES, SMOKE_PREFILL, SMOKE_TRAIN
from repro_torch.convert import model_params_from_reference
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model, input_specs
from repro_torch.models import layers as L
from repro_torch.runtime.steps import make_serve_step

import test_torch_models as tm

ARCH = "llava-next-34b"
B, S, EXTRA = 2, 24, 3          # S text tokens behind the 8 prefix rows
DTYPES = ("float32", "bfloat16")


def prefix_for(cfg, seed=17, batch=B) -> np.ndarray:
    """float32 patch embeddings [batch, P, d] (unit normal: larger than
    the pipeline's stub, so that the prefix moves the logits)."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


_PAIRS = {}


def pair(dtype: str):
    """(reference model, its params, the port's model with those params,
    jitted reference forward / prefill / decode(write=True))."""
    if dtype not in _PAIRS:
        rcfg = replace(REF_SMOKES[ARCH], dtype=dtype)
        cfg = replace(SMOKES[ARCH], dtype=dtype)
        ref = ref_build(rcfg, remat="none")
        params = ref.init_params(jax.random.PRNGKey(0))
        port = build_model(cfg, device="cpu")
        port.load_state_dict(model_params_from_reference(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        _PAIRS[dtype] = (
            ref, params, port,
            jax.jit(lambda p, t, pe: ref.forward(p, t, prefix_embeds=pe)),
            jax.jit(lambda p, t, pe: ref.prefill(p, t, prefix_embeds=pe)),
            jax.jit(lambda p, c, t: ref.decode(p, c, t, write=True)))
    return _PAIRS[dtype]


def tokens_for(cfg) -> np.ndarray:
    return np.random.default_rng(16).integers(
        0, cfg.vocab, (B, S + EXTRA)).astype(np.int32)


# -- config, specs, model ------------------------------------------------------

def test_llava_config_is_the_reference():
    for smoke in (False, True):
        cfg, ref = get_arch(ARCH, smoke=smoke), ref_get_arch(ARCH, smoke=smoke)
        assert cfg.to_dict() == ref.to_dict() and cfg.family == "vlm"
        assert cfg.n_params() == ref.n_params()
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.n_frontend_tokens) == \
        (60, 7168, 56, 8, 20480, 64000, 2880)
    model = build_model(get_arch(ARCH, smoke=True), device="cpu")
    assert model.cfg.family == "vlm" and len(model.layers) == 2
    assert not len(model.moe_layers) and model.mtp is None


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("smoke", [False, True])
def test_input_specs_match_the_reference(shape, smoke):
    """Names, shapes and dtypes of the step inputs: a train or prefill
    shape splits its positions into the prefix and the text tokens, a
    decode shape takes one token."""
    structs, _ = ref_input_specs(ref_get_arch(ARCH, smoke=smoke),
                                 REF_SHAPES[shape])
    got = input_specs(get_arch(ARCH, smoke=smoke), SHAPES[shape])
    assert {k: (v.shape, str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in structs.items()}


def test_input_specs_refuse_a_shape_the_prefix_fills():
    cfg = get_arch(ARCH)
    short = ShapeConfig(name="prefill_2k", seq_len=2048, global_batch=4,
                        kind="prefill")
    with pytest.raises(ValueError, match="2880 prefix rows"):
        input_specs(cfg, short)
    got = input_specs(cfg, replace(short, seq_len=2881))
    assert got["tokens"].shape == (4, 1)
    assert got["prefix_embeds"] == ((4, 2880, 7168), torch.bfloat16)


# -- forward, prefill, decode --------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_over_prefix_and_tokens(dtype):
    """Logits [B, P + S, V_pad] against the reference's; the prefix moves
    them, and a prefix given as embeddings of tokens equals those tokens."""
    ref, params, port, fwd, _, _ = pair(dtype)
    cfg = port.cfg
    tok, pre = tokens_for(cfg)[:, :S], prefix_for(cfg)
    want, _ = fwd(params, tok, pre)
    got, aux = port.forward(torch.from_numpy(tok).long(),
                            prefix_embeds=torch.from_numpy(pre))
    n = cfg.n_frontend_tokens
    assert got.shape == (B, n + S, L.pad_vocab(cfg.vocab))
    assert float(aux) == 0.0
    tm.close_logits(got, want, cfg, dtype)
    other, _ = port.forward(torch.from_numpy(tok).long(),
                            prefix_embeds=torch.from_numpy(prefix_for(
                                cfg, seed=18)))
    assert not torch.equal(other[:, n:], got[:, n:])
    assert torch.equal(other[:, n:], port.forward(
        torch.from_numpy(tok).long(), prefix_embeds=torch.from_numpy(
            prefix_for(cfg, seed=18)).to(cfg.torch_dtype))[0][:, n:])
    if dtype == "float32":      # embeddings as a prefix = their tokens
        head = torch.from_numpy(tok[:, :n]).long()
        via, _ = port.forward(torch.from_numpy(tok[:, n:]).long(),
                              prefix_embeds=L.embed_lookup(port.embed, head))
        plain, _ = port.forward(torch.from_numpy(tok).long())
        assert torch.equal(via, plain)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_three_decode_steps(dtype):
    """Prefill of P + S positions: the last logits, every cache row and
    ``length`` = P + S against the reference's; then three decode steps
    with ``write=True`` into a cache with room (the reference's padded by
    hand), positions continuing from P + S."""
    ref, params, port, _, pre_fn, dec = pair(dtype)
    cfg = port.cfg
    n = cfg.n_frontend_tokens
    tok, pre = tokens_for(cfg), prefix_for(cfg)
    want_l, rc = pre_fn(params, tok[:, :S], pre)
    got_l, pc = port.prefill(torch.from_numpy(tok[:, :S]).long(),
                             prefix_embeds=torch.from_numpy(pre),
                             capacity=n + S + EXTRA)
    tm.close_logits(got_l, want_l, cfg, dtype)
    assert int(pc.length) == int(rc.length) == n + S
    assert pc.k.shape[2] == n + S + EXTRA
    tm.close(pc.k[:, :, :n + S], rc.k, tm.ACT_TOL[dtype])
    tm.close(pc.v[:, :, :n + S], rc.v, tm.ACT_TOL[dtype])
    rc = tm.pad_cache(rc, EXTRA)
    for i in range(EXTRA):
        step = tok[:, S + i:S + i + 1]
        want, rc = dec(params, rc, step)
        got, pc = port.decode(pc, torch.from_numpy(step).long())
        tm.close_logits(got, want, cfg, dtype)
        assert int(pc.length) == int(rc.length) == n + S + i + 1
    tm.close(pc.k, rc.k, tm.ACT_TOL[dtype])
    tm.close(pc.v, rc.v, tm.ACT_TOL[dtype])
    with pytest.raises(ValueError, match="capacity"):
        port.prefill(torch.from_numpy(tok[:, :S]).long(),
                     prefix_embeds=torch.from_numpy(pre), capacity=S)


def test_decode_continues_the_forward():
    """Port alone at float32: prefill of prefix + S tokens and three cached
    decodes give the forward's logits at positions P + S .. P + S + 2."""
    _, _, port, _, _, _ = pair("float32")
    n = port.cfg.n_frontend_tokens
    tok = torch.from_numpy(tokens_for(port.cfg)).long()
    pre = torch.from_numpy(prefix_for(port.cfg))
    full, _ = port.forward(tok, prefix_embeds=pre)
    _, cache = port.prefill(tok[:, :S], prefix_embeds=pre,
                            capacity=n + S + EXTRA)
    for i in range(EXTRA):
        got, cache = port.decode(cache, tok[:, S + i:S + i + 1])
        tm.close(got, full[:, n + S + i], dict(atol=1e-4, rtol=0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_make_serve_step_takes_the_prefix(dtype):
    """The serve step on SMOKE_PREFILL's batch (8 prefix rows + 24 text
    tokens): its inputs are input_specs', its prefill and one decode equal
    the reference model's; an input the family does not take is
    refused."""
    ref, params, port, _, pre_fn, dec = pair(dtype)
    cfg = port.cfg
    n = cfg.n_frontend_tokens
    ss = make_serve_step(cfg, SMOKE_PREFILL, device="cpu",
                         decode_write=True,
                         capacity=SMOKE_PREFILL.seq_len + 1)
    ss.model.load_state_dict(port.state_dict())
    text = SMOKE_PREFILL.seq_len - n
    assert ss.input_structs["tokens"].shape == (B, text)
    assert ss.input_structs["prefix_embeds"].shape == (B, n, cfg.d_model)
    tok, pre = tokens_for(cfg)[:, :text + 1], prefix_for(cfg)
    logits, cache = ss.prefill({
        "tokens": torch.from_numpy(tok[:, :-1]).long(),
        "prefix_embeds": torch.from_numpy(pre)})
    want_l, rc = pre_fn(params, tok[:, :-1], pre)
    tm.close_logits(logits, want_l, cfg, dtype)
    logits2, cache = ss.decode(cache, torch.from_numpy(tok[:, -1:]).long())
    want2, rc = dec(params, tm.pad_cache(rc, 1), tok[:, -1:])
    tm.close_logits(logits2, want2, cfg, dtype)
    tm.close(cache.k, rc.k, tm.ACT_TOL[dtype])
    with pytest.raises(NotImplementedError, match="frame_embeds"):
        ss.prefill({"tokens": torch.from_numpy(tok[:, :-1]).long(),
                    "prefix_embeds": torch.from_numpy(pre),
                    "frame_embeds": None})


@pytest.mark.parametrize("case", ["no_prefix", "short_prefix",
                                  "long_tokens"])
def test_serve_step_checks_its_inputs(case):
    """The serve step's prefill refuses a batch without the prefix, with
    a prefix of another row count, or with tokens past the shape's, and
    builds no cache: a text-only prefill would answer otherwise."""
    cfg = SMOKES[ARCH]
    ss = make_serve_step(cfg, SMOKE_PREFILL, device="cpu")
    text = SMOKE_PREFILL.seq_len - cfg.n_frontend_tokens
    tok = torch.from_numpy(tokens_for(cfg)).long()
    pre = torch.from_numpy(prefix_for(cfg))
    batch, match = {
        "no_prefix": ({"tokens": tok[:, :text]}, "lacks 'prefix_embeds'"),
        "short_prefix": ({"tokens": tok[:, :text],
                          "prefix_embeds": pre[:, :4]},
                         "prefix_embeds of shape"),
        "long_tokens": ({"tokens": tok[:, :text + 1],
                         "prefix_embeds": pre}, "tokens of shape"),
    }[case]
    with pytest.raises(ValueError, match=match):
        ss.prefill(batch)


# -- the private twin with an image prefix --------------------------------------

def test_client_prefix_is_the_pipeline_stub():
    """The client's prefix is batch 0's ``prefix_embeds``, the port's
    pipeline's and the reference's, bit for bit."""
    cfg = SMOKES[ARCH]
    got = pi.client_prefix(cfg, 3, seed=5)
    want = TokenPipeline(cfg, replace(SMOKE_TRAIN, global_batch=3),
                         seed=5).batch(0)["prefix_embeds"]
    np.testing.assert_array_equal(got, want)
    ref = RefPipeline(REF_SMOKES[ARCH], replace(REF_SMOKE_TRAIN,
                                                global_batch=3), seed=5)
    np.testing.assert_array_equal(got, ref.batch(0)["prefix_embeds"])


@pytest.mark.parametrize("streams,tokens", [(1, 2), (3, 3)])
def test_twin_fetches_only_the_text_tokens(streams, tokens):
    """llava SMOKE on the CPU: the client's prefix stays local, every text
    token's row comes through TwoServerPIR bit-exact, the tokens equal the
    plain-lookup loop's, and only text tokens are queried (the prompt,
    one per stream per further token, one alone)."""
    out = pi.run(device="cpu", arch=ARCH, smoke=True, tokens=tokens,
                 streams=streams, seed=5, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert out["prefix_rows"] == SMOKES[ARCH].n_frontend_tokens
    assert [c["queries"] for c in out["pir_calls"]] == \
        [3 * streams] + [streams] * (tokens - 1) + [1]
    assert np.asarray(out["streams"]).shape == (streams, 3 + tokens)


def test_twin_prefix_is_the_models_input():
    """The twin with a given prefix generates what a model prefilled from
    that prefix and the prompt's rows generates; another prefix changes
    the first new token of some stream; a text-only arch draws none."""
    cfg = SMOKES[ARCH]
    model = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(9))
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (4, 5))
    pre = prefix_for(cfg, seed=21, batch=4)
    out = pi.run(model=model, prompt=prompt, prefix=pre, tokens=2,
                 streams=4, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    tok = torch.from_numpy(prompt).long()
    logits, _ = model.prefill(tok, prefix_embeds=torch.from_numpy(pre))
    first = np.asarray(out["streams"])[:, 5]
    np.testing.assert_array_equal(first, logits[:, :cfg.vocab].argmax(-1))
    other = pi.run(model=model, prompt=prompt, tokens=2, streams=4, seed=8,
                   verbose=False)
    assert (np.asarray(other["streams"])[:, 5] != first).any()
    assert pi.run(device="cpu", arch="qwen3-4b", smoke=True, tokens=2,
                  streams=2, verbose=False)["prefix_rows"] == 0


def test_twin_cli_on_llava_smoke(capsys):
    import json
    pi.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--tokens", "2",
             "--streams", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "llava-next-34b-smoke"
    assert summary["rows_exact"] and summary["plain_equal"]
    assert summary["prefix_rows"] == 8 and summary["queries"] == 6 + 2 + 1
