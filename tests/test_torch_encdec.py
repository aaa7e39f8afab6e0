"""Port: the audio family's serving path (whisper-small, ``EncDecLM``)
against the reference's ``repro.models.encdec`` on the CPU — the config,
``input_specs``, the encoder's pieces (GELU, ``sinusoid_positions``, the
chunk), ``encode``, ``forward``, ``prefill``, ``decode`` and the serve
step, and the private-embedding twin with the frames on the client.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference``; tokens and frames come from
numpy seeds, and the frames reach both packages in the config's dtype
(the port casts frames on entry; the reference, handed float32 frames,
would run its encoder in float32). Tolerances are
``tests/test_torch_models.py``'s: float32 logits, states and caches atol
1e-4; bfloat16 logits atol = rtol = 2e-2, bf16 states and caches atol
6e-2 with rtol 2^-6. The sinusoid positions are bit-equal, GELU within
1e-6 in float32 (``ACT_TOL`` in bf16), the twin's rows bit-exact
and its tokens those of the same loop on plain lookups.
"""
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.configs import get_arch as ref_get_arch
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import SMOKE_TRAIN as REF_SMOKE_TRAIN
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import build_model as ref_build
from repro.models import encdec as RE
from repro.models.registry import input_specs as ref_input_specs
from repro_torch import private_inference as pi
from repro_torch.configs import ARCHS, NOT_PORTED, SMOKES, get_arch
from repro_torch.configs.shapes import SHAPES, SMOKE_PREFILL, SMOKE_TRAIN
from repro_torch.convert import model_params_from_reference
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import EncDecLM, build_model, input_specs
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.runtime.steps import make_serve_step

import test_torch_models as tm

ARCH = "whisper-small"
B, S, EXTRA = 2, 24, 3
DTYPES = ("float32", "bfloat16")


def frames_for(cfg, seed=17, batch=B, scale=1.0) -> np.ndarray:
    """float32 frame embeddings [batch, encoder_len, d], normal x
    ``scale`` (unit normal: larger than the pipeline's stub, so that the
    frames move the logits)."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32) * scale


def tokens_for(cfg) -> np.ndarray:
    return np.random.default_rng(16).integers(
        0, cfg.vocab, (B, S + EXTRA)).astype(np.int32)


_PAIRS = {}


def pair(dtype: str):
    """(reference model, its params, the port's model with those params,
    jitted reference encode / forward / prefill / decode by write)."""
    if dtype not in _PAIRS:
        rcfg = replace(REF_SMOKES[ARCH], dtype=dtype)
        cfg = replace(SMOKES[ARCH], dtype=dtype)
        ref = ref_build(rcfg, remat="none")
        params = ref.init_params(jax.random.PRNGKey(0))
        port = build_model(cfg, device="cpu")
        port.load_state_dict(model_params_from_reference(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        _PAIRS[dtype] = (
            ref, params, port, jax.jit(ref.encode),
            jax.jit(lambda p, t, f: ref.forward(p, t, frame_embeds=f)),
            jax.jit(lambda p, t, f: ref.prefill(p, t, frame_embeds=f)),
            {w: jax.jit(lambda p, c, t, w=w: ref.decode(p, c, t, write=w))
             for w in (True, False)})
    return _PAIRS[dtype]


def both_frames(cfg, dtype, seed=17):
    return tm.both(frames_for(cfg, seed), dtype)


def pad_cache(cache: RE.EncDecCache, extra: int) -> RE.EncDecCache:
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return cache._replace(self_k=jnp.pad(cache.self_k, pad),
                          self_v=jnp.pad(cache.self_v, pad))


# -- config, specs, pieces ------------------------------------------------------

def test_whisper_config_is_the_reference():
    for smoke in (False, True):
        cfg, ref = get_arch(ARCH, smoke=smoke), ref_get_arch(ARCH, smoke=smoke)
        assert cfg.to_dict() == ref.to_dict() and cfg.family == "audio"
        assert cfg.n_params() == ref.n_params()
    full = get_arch(ARCH)
    assert (full.n_layers, full.n_encoder_layers, full.d_model,
            full.n_heads, full.n_kv_heads, full.d_ff, full.vocab,
            full.encoder_len, full.pos_kind) == \
        (12, 12, 768, 12, 12, 3072, 51865, 1500, "learned")
    assert ARCH in ARCHS and NOT_PORTED == {}
    model = build_model(SMOKES[ARCH], device="cpu")
    assert isinstance(model, EncDecLM)
    assert (len(model.enc_layers), len(model.dec_layers)) == (2, 2)
    assert model.pos_dec.shape == (32768, 64)
    assert model.embed.shape == (L.pad_vocab(512), 64)


def test_parameter_paths_are_the_reference_tree():
    """Every leaf of the reference's tree, unstacked, is one parameter of
    the port's module with the same shape and dtype, and back."""
    ref, params, port, *_ = pair("bfloat16")
    state = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), port.cfg)
    mine = port.state_dict()
    assert state.keys() == mine.keys()
    for k, v in state.items():
        assert v.shape == mine[k].shape and v.dtype == mine[k].dtype, k
    assert {k.split(".")[2] for k in state if k.startswith("dec_layers.")} \
        == {"ln1", "self_attn", "ln2", "cross_attn", "ln3", "mlp"}
    assert {k.split(".")[2] for k in state if k.startswith("enc_layers.")} \
        == {"ln1", "attn", "ln2", "mlp"}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("smoke", [False, True])
def test_input_specs_match_the_reference(shape, smoke):
    """Names, shapes and dtypes of the step inputs: ``tokens`` and the
    frames ``[B, encoder_len, d]`` in the config's dtype; a decode shape
    takes one token."""
    structs, _ = ref_input_specs(ref_get_arch(ARCH, smoke=smoke),
                                 REF_SHAPES[shape])
    got = input_specs(get_arch(ARCH, smoke=smoke), SHAPES[shape])
    assert {k: (v.shape, str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in structs.items()}


@pytest.mark.parametrize("n,d", [(1500, 768), (30, 64), (7, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sinusoid_positions_are_the_references(n, d, dtype):
    """float64 in numpy, then one rounding to the frames' dtype: the same
    bits as the reference's ``jnp.asarray(..., dtype)``."""
    np.testing.assert_array_equal(E.sinusoid_positions(n, d),
                                  RE.sinusoid_positions(n, d))
    got = E._positions_on(n, d, tm.TORCH_DT[dtype], torch.device("cpu"))
    want = jnp.asarray(RE.sinusoid_positions(n, d), tm.JNP_DT[dtype])
    np.testing.assert_array_equal(tm.to_np(got), tm.to_np(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_is_the_tanh_approximation(dtype):
    """``jax.nn.gelu``'s default is the tanh form: the port's ``gelu``
    equals it (float32 atol = rtol = 1e-6: the two frameworks evaluate
    tanh otherwise, measured 5.8e-7 in the negative tail; bf16 within the
    activations' ``ACT_TOL``: XLA rounds each step of the formula to bf16,
    torch rounds the float32 result once, measured 3.0e-3), and the erf
    form differs from it by more. In bf16 the port's is the float32 tanh
    form rounded once."""
    rx, px = tm.both(tm.randn(3, 4, 256) * 3, dtype)
    got, want = E.gelu(px), jax.nn.gelu(rx)
    assert got.dtype == px.dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        tm.ACT_TOL[dtype]
    np.testing.assert_allclose(tm.to_np(got), tm.to_np(want), **tol)
    assert torch.equal(got, E.gelu(px.float()).to(px.dtype))
    erf = torch.nn.functional.gelu(px.float())
    assert float((erf - got.float()).abs().max()) > 1e-4


def test_divisor_chunk_is_the_references():
    for n in (1500, 30, 7, 768, 769, 1536, 1):
        assert E._divisor_chunk(n) == RE._divisor_chunk(n)
    assert (E._divisor_chunk(1500), E._divisor_chunk(30)) == (750, 30)


# -- encode, forward, prefill, decode ----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode(dtype):
    ref, params, port, enc, *_ = pair(dtype)
    rf, pf = both_frames(port.cfg, dtype)
    got = port.encode(pf)
    assert got.shape == (B, 30, 64) and got.dtype == tm.TORCH_DT[dtype]
    tm.close(got, enc(params, rf), tm.ACT_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward(dtype):
    """Logits [B, S, V_pad] against the reference's, the padding rows
    masked; other frames change them; given embeddings equal the
    tokens' rows (the decoder positions added to both)."""
    ref, params, port, _, fwd, _, _ = pair(dtype)
    cfg = port.cfg
    tok = tokens_for(cfg)
    rf, pf = both_frames(cfg, dtype)
    want, _ = fwd(params, tok, rf)
    got, aux = port.forward(torch.from_numpy(tok).long(), frame_embeds=pf)
    assert got.shape == (B, S + EXTRA, L.pad_vocab(cfg.vocab))
    assert float(aux) == 0.0
    tm.close_logits(got, want, cfg, dtype)
    assert (got[..., cfg.vocab:] == L.NEG_INF).all()
    _, pf2 = both_frames(cfg, dtype, seed=18)
    other, _ = port.forward(torch.from_numpy(tok).long(), frame_embeds=pf2)
    assert not torch.equal(other, got)
    emb = L.embed_lookup(port.embed, torch.from_numpy(tok).long())
    via, _ = port.forward(embeds=emb, prefix_embeds=pf)
    assert torch.equal(via, got)
    with pytest.raises(ValueError, match="exactly one"):
        port.forward(torch.from_numpy(tok).long(), embeds=emb,
                     frame_embeds=pf)
    with pytest.raises(ValueError, match="frame_embeds"):
        port.forward(torch.from_numpy(tok).long())


def test_frames_are_cast_to_the_model_dtype():
    """float32 frames into a bf16 model run as the same frames cast first
    (input_specs declares them in the config's dtype)."""
    _, _, port, *_ = pair("bfloat16")
    tok = torch.from_numpy(tokens_for(port.cfg)).long()
    f32 = torch.from_numpy(frames_for(port.cfg))
    a, _ = port.forward(tok, frame_embeds=f32)
    b, _ = port.forward(tok, frame_embeds=f32.to(torch.bfloat16))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill(dtype):
    """The last logits, the self-attention rows, the cross K/V (once per
    layer) and ``length`` against the reference's prefill."""
    ref, params, port, _, _, pre, _ = pair(dtype)
    cfg = port.cfg
    tok = tokens_for(cfg)[:, :S]
    rf, pf = both_frames(cfg, dtype)
    want_l, rc = pre(params, tok, rf)
    got_l, pc = port.prefill(torch.from_numpy(tok).long(), frame_embeds=pf)
    tm.close_logits(got_l, want_l, cfg, dtype)
    assert int(pc.length) == int(rc.length) == S
    assert pc.length.dtype == torch.int32 and pc.length.dim() == 0
    for name in RE.EncDecCache._fields[:4]:
        got, want = getattr(pc, name), getattr(rc, name)
        assert tuple(got.shape) == tuple(want.shape), name
        tm.close(got, want, tm.ACT_TOL[dtype])
    assert pc.cross_k.shape == (2, B, 30, 4, 16)
    with pytest.raises(ValueError, match="capacity"):
        port.prefill(torch.from_numpy(tok).long(), frame_embeds=pf,
                     capacity=S - 1)


@pytest.mark.parametrize("mode", ["write", "no_write", "write_at_capacity"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_three_decode_steps(mode, dtype):
    """Prefill S tokens, then three decode steps against the reference's:
    ``write=True`` into a cache with room (the reference's padded by
    hand, the port's ``prefill(capacity=)``), ``write=False`` on the
    prefill's own cache, and ``write=True`` on a full cache (both write
    the last row, as dynamic_update_slice clamps)."""
    ref, params, port, _, _, pre, dec = pair(dtype)
    cfg = port.cfg
    tok = tokens_for(cfg)
    write = mode != "no_write"
    rf, pf = both_frames(cfg, dtype)
    _, rc = pre(params, tok[:, :S], rf)
    cap = S + EXTRA if mode == "write" else None
    if mode == "write":
        rc = pad_cache(rc, EXTRA)
    _, pc = port.prefill(torch.from_numpy(tok[:, :S]).long(),
                         frame_embeds=pf, capacity=cap)
    for i in range(EXTRA):
        step = tok[:, S + i:S + i + 1]
        want, rc = dec[write](params, rc, step)
        got, pc = port.decode(pc, torch.from_numpy(step).long(), write=write)
        assert got.shape == (B, L.pad_vocab(cfg.vocab))
        tm.close_logits(got, want, cfg, dtype)
        assert int(pc.length) == int(rc.length) == S + i + 1
    for name in RE.EncDecCache._fields[:4]:
        tm.close(getattr(pc, name), getattr(rc, name), tm.ACT_TOL[dtype])


def test_decode_continues_the_forward():
    """Port alone at float32: prefill + three cached decodes give the
    forward's logits at those positions; a decode from embeddings equals
    the decode from tokens."""
    _, _, port, *_ = pair("float32")
    tok = torch.from_numpy(tokens_for(port.cfg)).long()
    pf = torch.from_numpy(frames_for(port.cfg))
    full, _ = port.forward(tok, frame_embeds=pf)
    _, cache = port.prefill(tok[:, :S], frame_embeds=pf, capacity=S + EXTRA)
    for i in range(EXTRA):
        step = tok[:, S + i:S + i + 1]
        emb = L.embed_lookup(port.embed, step)
        via, _ = port.decode(cache, embeds=emb, write=False)
        got, cache = port.decode(cache, step)
        assert torch.equal(via, got)
        tm.close(got, full[:, S + i], dict(atol=1e-4, rtol=0))


def test_decoder_position_clamps_into_the_table():
    """The decoder row at ``length`` is read on the device and clamped
    into ``pos_dec`` as dynamic_slice_in_dim clamps its start."""
    _, params, port, *_ = pair("float32")
    emb = torch.zeros((1, 1, 64))
    n = port.MAX_DEC_POS
    for start, row in ((5, 5), (n - 1, n - 1), (n + 40, n - 1)):
        got = port._dec_embed(None, emb, torch.tensor(start,
                                                      dtype=torch.int32))
        assert torch.equal(got[0, 0], port.pos_dec[row])
        want = jax.lax.dynamic_slice_in_dim(params["pos_dec"],
                                            jnp.asarray(start), 1, 0)
        np.testing.assert_array_equal(tm.to_np(got[0]), np.asarray(want))


def test_remat_none_against_block():
    """remat="block" recomputes each encoder and decoder layer from its
    input: the same loss and gradients as remat="none", bit for bit on the
    CPU; the serve entry points record no graph either way."""
    cfg = replace(SMOKES[ARCH], dtype="float32")
    tok = torch.from_numpy(tokens_for(cfg)).long()
    pf = torch.from_numpy(frames_for(cfg))
    out = {}
    for remat in ("none", "block"):
        model = build_model(cfg, device="cpu", remat=remat).init_params(
            torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        loss, metrics = model.loss(tok, frame_embeds=pf)
        assert metrics == {}
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
        logits, _ = model.forward(tok, frame_embeds=pf)
        assert not logits.requires_grad
    assert torch.equal(out["none"][0], out["block"][0])
    for a, g in zip(out["none"][1], out["block"][1]):
        assert torch.equal(a, g)
    with pytest.raises(ValueError, match="unknown remat"):
        build_model(cfg, device="cpu", remat="full")


def test_init_params_from_a_generator():
    """Seeded: the same generator seed draws the same weights; the token
    table normal(0, 0.02), pos_dec normal(0, 0.01), matrices within
    1/sqrt(d_in), norms scale 1 and bias 0."""
    cfg = SMOKES[ARCH]
    a = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(7))
    b = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert abs(float(a.embed.float().std()) - 0.02) < 2e-3
    assert abs(float(a.pos_dec.float().std()) - 0.01) < 1e-3
    fc2 = a.dec_layers[1].mlp["fc2"].float()
    assert float(fc2.abs().max()) <= 1 / np.sqrt(cfg.d_ff)
    assert (a.enc_layers[0].ln2["scale"] == 1).all()
    assert not a.dec_norm["bias"].any()
    assert a.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
def test_make_serve_step_takes_the_frames(dtype):
    """The serve step on SMOKE_PREFILL's batch (32 tokens and 30 frames a
    stream): its inputs are input_specs', its prefill and one decode equal
    the reference model's."""
    ref, params, port, _, _, pre, dec = pair(dtype)
    cfg = port.cfg
    ss = make_serve_step(cfg, SMOKE_PREFILL, device="cpu",
                         decode_write=True,
                         capacity=SMOKE_PREFILL.seq_len + 1)
    ss.model.load_state_dict(port.state_dict())
    assert isinstance(ss.model, EncDecLM)
    assert ss.input_structs["tokens"].shape == (B, 32)
    assert ss.input_structs["frame_embeds"].shape == (B, 30, 64)
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (B, 33))
    rf, pf = both_frames(cfg, dtype)
    logits, cache = ss.prefill({"tokens": torch.from_numpy(tok[:, :-1]),
                                "frame_embeds": pf})
    want_l, rc = pre(params, tok[:, :-1], rf)
    tm.close_logits(logits, want_l, cfg, dtype)
    logits2, cache = ss.decode(cache, torch.from_numpy(tok[:, -1:]))
    want2, rc = dec[True](params, pad_cache(rc, 1), tok[:, -1:])
    tm.close_logits(logits2, want2, cfg, dtype)
    tm.close(cache.self_k, rc.self_k, tm.ACT_TOL[dtype])


@pytest.mark.parametrize("case", ["no_frames", "short_frames",
                                  "prefix_embeds"])
def test_serve_step_checks_its_inputs(case):
    """The serve step's prefill refuses a batch without the frames, with
    frames of another row count, or with another family's input."""
    cfg = SMOKES[ARCH]
    ss = make_serve_step(cfg, SMOKE_PREFILL, device="cpu")
    tok = torch.zeros((B, 32), dtype=torch.long)
    fr = torch.from_numpy(frames_for(cfg))
    batch, err, match = {
        "no_frames": ({"tokens": tok}, ValueError, "lacks 'frame_embeds'"),
        "short_frames": ({"tokens": tok, "frame_embeds": fr[:, :20]},
                         ValueError, "frame_embeds of shape"),
        "prefix_embeds": ({"tokens": tok, "frame_embeds": fr,
                           "prefix_embeds": fr}, NotImplementedError,
                          "prefix_embeds"),
    }[case]
    with pytest.raises(err, match=match):
        ss.prefill(batch)


# -- the private twin with the frames on the client -------------------------------

def test_client_frames_are_the_pipeline_stub():
    """The client's frames are batch 0's ``frame_embeds``, the port's
    pipeline's and the reference's, bit for bit."""
    cfg = SMOKES[ARCH]
    assert pi.side_input(cfg) == "frame_embeds"
    got = pi.client_prefix(cfg, 3, seed=5)
    assert got.shape == (3, 30, 64)
    want = TokenPipeline(cfg, replace(SMOKE_TRAIN, global_batch=3),
                         seed=5).batch(0)["frame_embeds"]
    np.testing.assert_array_equal(got, want)
    ref = RefPipeline(REF_SMOKES[ARCH], replace(REF_SMOKE_TRAIN,
                                                global_batch=3), seed=5)
    np.testing.assert_array_equal(got, ref.batch(0)["frame_embeds"])


@pytest.mark.parametrize("streams,tokens", [(1, 2), (3, 3)])
def test_twin_fetches_only_the_decoder_tokens(streams, tokens):
    """whisper SMOKE on the CPU: the frames stay on the client, every
    decoder token's row comes through TwoServerPIR bit-exact, the tokens
    equal the plain-lookup loop's, and only decoder tokens are queried
    (the prompt, one per stream per further token, one alone)."""
    out = pi.run(device="cpu", arch=ARCH, smoke=True, tokens=tokens,
                 streams=streams, seed=5, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert out["prefix_rows"] == SMOKES[ARCH].encoder_len
    assert [c["queries"] for c in out["pir_calls"]] == \
        [3 * streams] + [streams] * (tokens - 1) + [1]
    assert np.asarray(out["streams"]).shape == (streams, 3 + tokens)


def test_twin_frames_are_the_models_input():
    """The twin with given frames generates what a model prefilled from
    those frames and the prompt generates; other frames change the first
    new token of some stream; the cache holds decoder positions only.
    The frames are normal x 10: at random weights the cross-attention's
    average over 30 frames moves the logits little, and unit-normal
    frames of two seeds chose the same four first tokens."""
    cfg = SMOKES[ARCH]
    model = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(9))
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (4, 5))
    fr = frames_for(cfg, seed=21, batch=4, scale=10.0)
    out = pi.run(model=model, prompt=prompt, prefix=fr, tokens=2,
                 streams=4, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    logits, cache = model.prefill(torch.from_numpy(prompt).long(),
                                  frame_embeds=torch.from_numpy(fr))
    assert int(cache.length) == 5
    first = np.asarray(out["streams"])[:, 5]
    np.testing.assert_array_equal(first, logits[:, :cfg.vocab].argmax(-1))
    other = pi.run(model=model, prompt=prompt, tokens=2, streams=4,
                   prefix=frames_for(cfg, seed=22, batch=4, scale=10.0),
                   verbose=False)
    assert (np.asarray(other["streams"])[:, 5] != first).any()


def test_twin_cli_on_whisper_smoke(capsys):
    pi.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--tokens", "2",
             "--streams", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "whisper-small-smoke"
    assert summary["rows_exact"] and summary["plain_equal"]
    assert summary["prefix_rows"] == 30 and summary["queries"] == 6 + 2 + 1
