"""Port: the SSM family's serving path (xlstm-350m ``SMOKE``,
``XLSTMModel``) against the reference's ``repro.models.xlstm`` on the CPU
— the parameter tree through ``convert``, ``forward``, ``prefill`` and
``decode`` chains, ``loss``, the cache (independent of capacity), the
serve step, and the private-embedding twin.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference`` bit for bit (``r_rec`` float32
in the bf16 model too); tokens come from numpy seeds. Tolerances, each
with what was measured:
* float32: logits atol 1e-5 (measured at most 3.4e-7 on logits of
  magnitude 0.68), the cache's states atol 1e-5 (measured 1.7e-6 on
  states of magnitude up to 5.5), the loss rtol 1e-6 (measured 0);
* bfloat16: logits atol 2e-2 (``tests/test_torch_models.py``'s; measured
  at most 5.6e-3), the cache's float32 states atol 0.1 (measured 2.8e-2
  on states of magnitude up to 5.6: the mLSTM's bf16 SiLUs and sigmoids
  round otherwise than XLA's, ``tests/test_torch_xlstm.py``), the bf16
  conv tails atol 2^-5 (measured 1.4e-2), the loss atol 2e-2 (measured
  1.8e-4);
* port against port (decode chain against the forward, ``remat``,
  ``embeds=``): float32 atol 1e-5 (measured 2.4e-7), or exact where the
  same operations run.
The twin's rows are bit-exact and its tokens those of the same loop on
plain lookups. torch is pinned to one thread.
"""
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import build_model as ref_build
from repro.models.registry import input_specs as ref_input_specs
from repro_torch import private_inference as pi
from repro_torch.configs import SMOKES, get_arch
from repro_torch.configs.shapes import SHAPES, SMOKE_PREFILL
from repro_torch.convert import leaf_paths, model_params_from_reference
from repro_torch.models import (XLSTMModel, Zamba2Model, build_model,
                                input_specs)
from repro_torch.models import layers as L
from repro_torch.models.xlstm import XLSTMCache
from repro_torch.runtime.steps import make_serve_step

ARCH = "xlstm-350m"
DTYPES = ("float32", "bfloat16")
B = 2
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
STATE_ATOL = {"float32": 1e-5, "bfloat16": 0.1}
TAIL_ATOL = {"float32": 1e-5, "bfloat16": 2 ** -5}
LOSS_TOL = {"float32": dict(rtol=1e-6, atol=0),
            "bfloat16": dict(rtol=0, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def tokens_for(n: int, seed: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, SMOKES[ARCH].vocab, (B, n)).astype(np.int32)


_PAIRS = {}


def pair(dtype: str):
    """(reference model, its params as numpy, the port's model with those
    params, jitted reference forward / prefill / decode), once a dtype."""
    if dtype not in _PAIRS:
        ref = ref_build(replace(REF_SMOKES[ARCH], dtype=dtype),
                        remat="none")
        params = jax.tree_util.tree_map(
            np.asarray, ref.init_params(jax.random.PRNGKey(0)))
        port = build_model(replace(SMOKES[ARCH], dtype=dtype), device="cpu")
        port.load_state_dict(model_params_from_reference(params, port.cfg))
        _PAIRS[dtype] = (ref, params, port, jax.jit(ref.forward),
                         jax.jit(ref.prefill), jax.jit(ref.decode))
    return _PAIRS[dtype]


def caches_close(got: XLSTMCache, want, dtype):
    """Every block's tensors against the reference's: float32 states at
    ``STATE_ATOL``, the conv tails (model dtype) at ``TAIL_ATOL``."""
    assert int(got.length) == int(want.length)
    assert len(got.blocks) == len(want.blocks)
    for g_block, w_block in zip(got.blocks, want.blocks):
        assert len(g_block) == len(w_block)
        for g, w in zip(g_block, w_block):
            assert tuple(g.shape) == w.shape
            atol = (STATE_ATOL if g.dtype == torch.float32
                    else TAIL_ATOL)[dtype]
            np.testing.assert_allclose(as_np(g), as_np(w), rtol=0,
                                       atol=atol)


# -- the parameter tree -----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_parameter_paths_are_the_reference_tree(dtype):
    """Every leaf of the reference's list of blocks is one parameter of
    the port's module (``blocks/3/mix/r_rec`` -> ``blocks.3.mix.r_rec``)
    with the same shape, dtype and bits, and back; ``r_rec`` stays float32
    in a bf16 model."""
    _, params, port, *_ = pair(dtype)
    state = model_params_from_reference(params, port.cfg)
    mine = port.state_dict()
    assert state.keys() == mine.keys()
    assert len(state) == len(dict(leaf_paths(params)))
    for k, v in state.items():
        assert v.dtype == mine[k].dtype and v.shape == mine[k].shape, k
        assert torch.equal(v, mine[k]), k
    assert [b.kind for b in port.blocks] == ["mlstm", "slstm"] * 2
    assert state["blocks.1.mix.r_rec"].dtype == torch.float32
    assert state["blocks.0.mix.wqkv"].dtype == port.cfg.torch_dtype
    assert set(port.blocks[0].mix) == {"in_proj", "conv_w", "wqkv", "wif",
                                       "norm", "out_proj"}
    assert set(port.blocks[1].mix) == {"w_in", "r_rec", "norm", "out_proj"}


def test_build_model_serves_the_ssm_family_only():
    """``build_model`` gives an XLSTMModel for the SSM family (and a
    Zamba2Model for the hybrid); XLSTMModel refuses a config of another
    family or without ``ssm=``."""
    model = build_model(SMOKES[ARCH], device="cpu")
    assert isinstance(model, XLSTMModel)
    assert model.embed.shape == (L.pad_vocab(512), 64)
    assert model.device.type == "cpu"
    assert isinstance(build_model(SMOKES["zamba2-7b"], device="cpu"),
                      Zamba2Model)
    with pytest.raises(ValueError, match="ssm="):
        XLSTMModel(replace(SMOKES[ARCH], family="hybrid"), device="cpu")
    with pytest.raises(ValueError, match="ssm="):
        XLSTMModel(replace(SMOKES[ARCH], ssm=None), device="cpu")


def test_init_params_from_a_generator():
    """The reference's distributions, drawn on the module's device: the
    tables normal x 0.02 (padding rows included), norms zero, ``r_rec``
    float32 within ±0.1/sqrt(d), ``conv_w`` of std near 0.1; the same
    generator seed draws the same weights."""
    cfg = get_arch(ARCH, smoke=True)
    m1 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    m2 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert 0.018 < float(m1.embed.float().std()) < 0.022
    assert 0.018 < float(m1.unembed.float().std()) < 0.022
    assert not m1.final_norm.any() and not m1.blocks[0].norm.any()
    r = m1.blocks[1].mix["r_rec"]
    assert r.dtype == torch.float32
    assert float(r.abs().max()) <= 0.1 / np.sqrt(cfg.d_model)
    assert 0.08 < float(m1.blocks[0].mix["conv_w"].float().std()) < 0.12


# -- forward, prefill, decode, loss ----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_the_reference(dtype):
    """Logits over 32 tokens (two chunks of 16) and the zero aux."""
    _, params, port, fwd, *_ = pair(dtype)
    tok = tokens_for(32)
    want, waux = fwd(params, tok)
    got, aux = port.forward(torch.from_numpy(tok).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(waux) == 0.0
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0,
                               atol=LOGIT_ATOL[dtype])
    assert (got[..., SMOKES[ARCH].vocab:] == L.NEG_INF).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prompt", [16, 32], ids=["one_chunk", "chunks"])
def test_prefill_and_decode_chain_match_the_reference(dtype, prompt):
    """A prefill over ``prompt`` tokens, then five decode steps: each
    step's logits and the cache (every block's tensors, the length)
    against the reference's."""
    _, params, port, _, pre, dec = pair(dtype)
    tok = tokens_for(prompt + 5, seed=prompt)
    want, wcache = pre(params, tok[:, :prompt])
    got, cache = port.prefill(torch.from_numpy(tok[:, :prompt]).long())
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0,
                               atol=LOGIT_ATOL[dtype])
    caches_close(cache, wcache, dtype)
    for i in range(prompt, prompt + 5):
        want, wcache = dec(params, wcache, tok[:, i:i + 1])
        got, cache = port.decode(cache, torch.from_numpy(
            tok[:, i:i + 1]).long())
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=0,
                                   atol=LOGIT_ATOL[dtype])
    caches_close(cache, wcache, dtype)
    assert int(cache.length) == prompt + 5


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_matches_the_reference(dtype):
    """The loss (empty metrics): the cross-entropy of the forward's
    logits[:, :-1] against tokens[:, 1:]."""
    ref, params, port, *_ = pair(dtype)
    tok = tokens_for(32, seed=5)
    want, wm = jax.jit(ref.loss)(params, tok)
    got, gm = port.loss(torch.from_numpy(tok))
    assert wm == {} and gm == {}
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL[dtype])


def test_prompt_length_must_fit_the_chunk():
    """20 tokens at chunk 16 raise the reference's ValueError in both
    packages (prompts up to 16 tokens, or a multiple of 16, pass)."""
    ref, params, port, *_ = pair("float32")
    tok = tokens_for(20)
    with pytest.raises(ValueError, match="not divisible by chunk=16"):
        ref.prefill(params, tok)
    with pytest.raises(ValueError, match="not divisible by chunk=16"):
        port.prefill(torch.from_numpy(tok).long())
    port.prefill(torch.from_numpy(tok[:, :13]).long())


# -- the cache ----------------------------------------------------------------------

def test_cache_shapes_are_independent_of_capacity():
    """``init_cache(B, capacity)``: the reference's shapes and dtypes at
    any capacity, the same bytes at 16 and 524,288 (long_500k's length),
    zero but the sLSTM's n (1e-6), length 0; a prefill's cache has the
    same shapes."""
    ref, _, port, *_ = pair("bfloat16")
    for cap in (16, 524_288):
        want = jax.eval_shape(lambda: ref.init_cache(B, cap))
        got = port.init_cache(B, cap)
        assert isinstance(got, XLSTMCache)
        assert [[(tuple(t.shape), str(t.dtype).split(".")[-1])
                 for t in blk] for blk in got.blocks] == \
            [[(w.shape, str(w.dtype)) for w in blk] for blk in want.blocks]
        assert int(got.length) == 0
    small, large = port.init_cache(B, 16), port.init_cache(B, 524_288)
    assert small.nbytes() == large.nbytes()
    d_inner, h = 128, 4
    assert small.nbytes() == 2 * (B * 3 * d_inner * 2
                                  + B * h * (d_inner // h + 1)
                                  * (d_inner // h) * 4) + 2 * 4 * B * 64 * 4
    slstm = small.blocks[1]
    assert not slstm[0].any() and (slstm[1] == 1e-6).all()
    _, cache = port.prefill(torch.from_numpy(tokens_for(16)).long())
    assert [[t.shape for t in b] for b in cache.blocks] == \
        [[t.shape for t in b] for b in small.blocks]


def test_decode_continues_the_forward_and_leaves_its_cache():
    """float32: a prefill over 16 tokens and 16 decode steps give the
    forward's logits over 32 at every step; a decode returns new tensors
    (the given cache is not written, ``write=False`` advances all the
    same); a stream's slice of the cache decodes as that stream's row."""
    _, _, port, *_ = pair("float32")
    tok = torch.from_numpy(tokens_for(32, seed=8)).long()
    full, _ = port.forward(tok)
    logits, cache = port.prefill(tok[:, :16])
    torch.testing.assert_close(logits, full[:, 15], rtol=0, atol=1e-5)
    for i in range(16, 32):
        before = [t.clone() for blk in cache.blocks for t in blk]
        logits, new = port.decode(cache, tok[:, i:i + 1],
                                  write=bool(i % 2))
        assert all(torch.equal(a, b) for a, b in zip(
            before, (t for blk in cache.blocks for t in blk)))
        torch.testing.assert_close(logits, full[:, i], rtol=0, atol=1e-5)
        if i == 16:
            one, _ = port.decode(cache.streams(1, 2), tok[1:2, i:i + 1])
            torch.testing.assert_close(one[0], logits[1], rtol=0,
                                       atol=1e-5)
        cache = new
    assert int(cache.length) == 32


def test_embeds_in_place_of_tokens():
    """``embeds=`` (the table's rows) give the token path's logits and
    cache exactly; both or neither raise."""
    _, _, port, *_ = pair("bfloat16")
    tok = torch.from_numpy(tokens_for(16, seed=3)).long()
    rows = port.embed[tok]
    a, _ = port.forward(tok)
    b, _ = port.forward(embeds=rows)
    assert torch.equal(a, b)
    la, ca = port.prefill(tok)
    lb, cb = port.prefill(embeds=rows, capacity=999)
    assert torch.equal(la, lb)
    da, _ = port.decode(ca, tok[:, :1])
    db, _ = port.decode(cb, embeds=rows[:, :1])
    assert torch.equal(da, db)
    with pytest.raises(ValueError, match="exactly one"):
        port.forward(tok, embeds=rows)
    with pytest.raises(ValueError, match="exactly one"):
        port.prefill()


def test_remat_none_against_block():
    """float32: the loss and every gradient with ``remat="block"``
    (each block recomputed in the backward pass) equal ``"none"``'s."""
    _, params, _, *_ = pair("float32")
    cfg = replace(SMOKES[ARCH], dtype="float32")
    tok = torch.from_numpy(tokens_for(32, seed=4))
    grads = {}
    for remat in ("none", "block"):
        model = build_model(cfg, device="cpu", remat=remat)
        model.load_state_dict(model_params_from_reference(params, cfg))
        model.requires_grad_(True)
        loss, _ = model.loss(tok)
        grads[remat] = (loss, torch.autograd.grad(
            loss, list(model.parameters())))
    torch.testing.assert_close(grads["none"][0], grads["block"][0],
                               rtol=0, atol=0)
    for a, b in zip(grads["none"][1], grads["block"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


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


def test_make_serve_step_on_xlstm():
    """make_serve_step at SMOKE: the prefill takes ``tokens`` alone (a
    capacity is ignored), refuses a side input; decode with
    ``decode_write`` either way advances the state; the logits are the
    model's own."""
    ss = make_serve_step(SMOKES[ARCH], SMOKE_PREFILL, device="cpu",
                         decode_write=True, capacity=64)
    ss.model.init_params(torch.Generator().manual_seed(1))
    tok = torch.from_numpy(tokens_for(32, seed=2)).long()
    logits, cache = ss.prefill({"tokens": tok})
    want, _ = ss.model.prefill(tok)
    assert torch.equal(logits, want) and int(cache.length) == 32
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        ss.prefill({"tokens": tok, "prefix_embeds": torch.zeros(1)})
    logits, cache = ss.decode(cache, tok[:, :1])
    assert int(cache.length) == 33 and torch.isfinite(logits).all()


@pytest.mark.parametrize("streams,tokens", [(2, 4), (4, 3)])
def test_twin_on_xlstm_smoke(streams, tokens):
    """xlstm SMOKE on the CPU: every token's row through TwoServerPIR
    bit-exact over the 2^9-row table, the tokens equal the plain-lookup
    loop's, no side input, and the queries are the prompt's, one per
    stream per further token, one alone (the solo step on a stream's
    slice of the recurrent state)."""
    out = pi.run(device="cpu", arch=ARCH, smoke=True, tokens=tokens,
                 streams=streams, seed=5, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert out["prefix_rows"] == 0 and pi.side_input(SMOKES[ARCH]) is None
    assert [c["queries"] for c in out["pir_calls"]] == \
        [3 * streams] + [streams] * (tokens - 1) + [1]
    assert np.asarray(out["streams"]).shape == (streams, 3 + tokens)
    assert pi.padded_rows(SMOKES[ARCH].vocab) == 1 << 9
    assert pi.padded_rows(get_arch(ARCH).vocab) == 1 << 16


def test_twin_cli_on_xlstm_smoke(capsys):
    pi.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--tokens", "2",
             "--streams", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "xlstm-350m-smoke"
    assert summary["rows_exact"] and summary["plain_equal"]
    assert summary["queries"] == 6 + 2 + 1
