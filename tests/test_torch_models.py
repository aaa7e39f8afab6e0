"""Port: the dense LM (``repro_torch/models``) against the reference on the
CPU.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models``; the reference's parameters (drawn from
``PRNGKey(0)``) reach the port through ``convert.model_params_from_reference``.
Tolerances: at float32 atol 1e-4 on logits and caches (measured: below
3e-6); at bfloat16 atol = rtol = 2e-2 on the float32 logits (measured:
below 6.4e-3 on logits of magnitude up to 0.8) and, on the bf16 caches and
activations, atol 6e-2 with rtol 2^-6: two bf16 ulps (2^-5 each) at the
largest magnitudes the keys reach, 4 to 8 (measured: 0.0405 on a
second-layer qwen3 key, after the first layer's residual stream). bf16
rounds where the two frameworks' matmuls and elementwise kernels round,
which is not always the same place, and the differences carry from layer
to layer.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SMOKES as REF_SMOKES
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build
from repro.models import layers as RL
from repro.models.transformer import KVCache as RefCache
from repro_torch.config import ShapeConfig
from repro_torch.configs import ARCHS, NOT_PORTED, SMOKES, get_arch
from repro_torch.configs.shapes import SHAPES, SMOKE_PREFILL
from repro_torch.convert import (model_params_from_reference,
                                 tensor_from_reference)
from repro_torch.models import build_model, input_specs
from repro_torch.models import layers as L
from repro_torch.runtime.steps import make_serve_step

B, S, EXTRA = 2, 32, 3
#: the dense archs (the MoE family's are tests/test_torch_moe.py's)
DENSE = sorted(k for k, c in SMOKES.items() if c.family == "dense")
DTYPES = ("float32", "bfloat16")
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=0),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
ACT_TOL = {"float32": dict(atol=1e-4, rtol=0),
           "bfloat16": dict(atol=6e-2, rtol=2 ** -6)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def to_np(x) -> np.ndarray:
    """A reference array or a port tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def both(arr: np.ndarray, dtype: str):
    """One float32 numpy array as the same-valued reference and port
    inputs in ``dtype`` (both round to nearest even)."""
    return (jnp.asarray(arr, JNP_DT[dtype]),
            torch.from_numpy(arr).to(TORCH_DT[dtype]))


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_the_reference(arch):
    for smoke in (False, True):
        cfg, ref = get_arch(arch, smoke=smoke), ref_get_arch(arch, smoke=smoke)
        assert cfg.to_dict() == ref.to_dict()
        assert cfg.n_params() == ref.n_params()
        assert cfg.n_active_params() == ref.n_active_params()
        assert cfg.resolved_head_dim == ref.resolved_head_dim
    assert get_arch(arch).torch_dtype == torch.bfloat16


def test_shapes_match_the_reference():
    from repro.configs.shapes import SHAPES as REF_SHAPES
    assert {k: v.to_dict() for k, v in SHAPES.items()} == \
        {k: v.to_dict() for k, v in REF_SHAPES.items()}


def test_get_arch_raises_for_families_not_ported(monkeypatch):
    """Every arch of the reference is ported (``NOT_PORTED`` is empty);
    an arch listed there, as one a later reference adds would be, raises
    for FULL and SMOKE."""
    assert NOT_PORTED == {} and sorted(ARCHS) == sorted(REF_ARCHS)
    monkeypatch.setitem(NOT_PORTED, "later-arch", "newfamily")
    for smoke in (False, True):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_arch("later-arch", smoke=smoke)


def test_get_arch_unknown_and_build_model_other_family():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    moe = replace(SMOKES["granite-3-2b"], family="moe")
    with pytest.raises(ValueError, match="needs moe="):
        build_model(moe, device="cpu")
    with pytest.raises(ValueError, match="ssm="):
        build_model(replace(moe, family="hybrid"), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(replace(moe, family="mystery"), device="cpu")


def test_input_specs():
    cfg = SMOKES["qwen3-4b"]
    assert input_specs(cfg, SMOKE_PREFILL)["tokens"] == ((2, 32), torch.int32)
    dec = ShapeConfig(name="d", seq_len=32, global_batch=3, kind="decode")
    assert input_specs(cfg, dec)["tokens"].shape == (3, 1)


# -- layer functions ----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_norms(dtype):
    rx, px = both(randn(1, 2, 5, 64) * 3, dtype)
    rs, ps = both(randn(2, 64) * 0.1, dtype)
    rb, pb = both(randn(3, 64) * 0.1, dtype)
    close(L.rmsnorm(px, ps, 1e-5), RL.rmsnorm(rx, rs, 1e-5), ACT_TOL[dtype])
    close(L.layernorm(px, ps, pb, 1e-6), RL.layernorm(rx, rs, rb, 1e-6),
          ACT_TOL[dtype])
    assert L.rmsnorm(px, ps).dtype == TORCH_DT[dtype]


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(theta, dtype):
    np.testing.assert_array_equal(L.rope_freqs(32, theta),
                                  RL.rope_freqs(32, theta))
    rx, px = both(randn(4, 2, 7, 4, 32), dtype)
    pos = np.arange(7)[None, :] + 1000
    close(L.apply_rope(px, torch.from_numpy(pos), theta),
          RL.apply_rope(rx, jnp.asarray(pos), theta), ACT_TOL[dtype])


ATTN_CASES = {
    # name: (sq, skv, causal, q_offset, kv_len)
    "causal_3x3_chunks": (48, 48, True, 0, None),
    "full_3x3_chunks": (48, 48, False, 0, None),
    "continuation_q_offset": (16, 48, True, 32, None),
    "kv_len_masks_tail": (16, 48, True, 16, 37),
    "odd_length_one_chunk": (20, 20, True, 0, None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_attention(case, dtype):
    sq, skv, causal, q_offset, kv_len = ATTN_CASES[case]
    rq, pq = both(randn(5, 2, sq, 4, 16), dtype)
    rk, pk = both(randn(6, 2, skv, 2, 16), dtype)
    rv, pv = both(randn(7, 2, skv, 2, 16), dtype)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16)
    want = RL.chunked_attention(
        rq, rk, rv, q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw)
    for off, kl in ((q_offset, kv_len),
                    (torch.tensor(q_offset),
                     None if kv_len is None else torch.tensor(kv_len))):
        got = L.chunked_attention(pq, pk, pv, q_offset=off, kv_len=kl, **kw)
        assert got.shape == (2, sq, 4, 16) and got.dtype == pq.dtype
        close(got, want, ACT_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention(dtype):
    rq, pq = both(randn(8, 2, 1, 4, 16), dtype)
    rk, pk = both(randn(9, 2, 24, 2, 16), dtype)
    rv, pv = both(randn(10, 2, 24, 2, 16), dtype)
    rkn, pkn = both(randn(11, 2, 1, 2, 16), dtype)
    rvn, pvn = both(randn(12, 2, 1, 2, 16), dtype)
    close(L.decode_attention_append(pq, pk, pv, pkn, pvn, torch.tensor(17)),
          RL.decode_attention_append(rq, rk, rv, rkn, rvn, jnp.asarray(17)),
          ACT_TOL[dtype])
    lens = np.asarray([5, 24])
    close(L.decode_attention(pq, pk, pv, torch.from_numpy(lens)),
          RL.decode_attention(rq, rk, rv, jnp.asarray(lens)), ACT_TOL[dtype])


def _tree_to_port(tree):
    return {k: tensor_from_reference(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_block_and_mlp(arch, dtype):
    cfg = replace(SMOKES[arch], dtype=dtype)
    rcfg = replace(REF_SMOKES[arch], dtype=dtype)
    rp = RL.gqa_init(jax.random.PRNGKey(3), rcfg)
    pp = _tree_to_port(rp)
    rx, px = both(randn(13, 2, 32, cfg.d_model), dtype)
    pos = np.arange(32)[None, :]
    rqkv = RL.gqa_qkv(rp, rcfg, rx, jnp.asarray(pos))
    pqkv = L.gqa_qkv(pp, cfg, px, torch.from_numpy(pos))
    for got, want in zip(pqkv, rqkv):
        close(got, want, ACT_TOL[dtype])
    rout, _ = RL.gqa_attend(rp, rcfg, rx, jnp.asarray(pos))
    pout, _ = L.gqa_attend(pp, cfg, px, torch.from_numpy(pos))
    close(pout, rout, ACT_TOL[dtype])
    rm = RL.mlp_init(jax.random.PRNGKey(4), cfg.d_model, cfg.d_ff, dtype)
    close(L.mlp_apply(_tree_to_port(rm), px), RL.mlp_apply(rm, rx),
          ACT_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_embeddings(dtype):
    assert [L.pad_vocab(v) for v in (1, 256, 257, 151936)] == \
        [RL.pad_vocab(v) for v in (1, 256, 257, 151936)]
    rt = RL.embed_init(jax.random.PRNGKey(5), 300, 32, JNP_DT[dtype])
    pt = tensor_from_reference(np.asarray(rt))
    assert pt.shape == (512, 32)
    tok = np.random.default_rng(14).integers(0, 300, (2, 6))
    np.testing.assert_array_equal(
        to_np(L.embed_lookup(pt, torch.from_numpy(tok))),
        to_np(RL.embed_lookup(rt, jnp.asarray(tok))))
    rx, px = both(randn(15, 2, 6, 32), dtype)
    got, want = L.unembed(px, pt, 300), RL.unembed(rx, rt, 300)
    assert got.dtype == torch.float32
    close(got[..., :300], np.asarray(want)[..., :300], LOGIT_TOL[dtype])
    assert (got[..., 300:] == L.NEG_INF).all()


def test_init_params_from_a_generator():
    """Seeded: the same generator seed draws the same weights, tables
    normal(0, 0.02), matrices within 1/sqrt(d_in), norm scales 0."""
    cfg = SMOKES["qwen3-4b"]
    a = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(7))
    b = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert abs(float(a.embed.float().std()) - 0.02) < 2e-3
    wq = a.layers[0].attn["wq"].float()
    assert float(wq.abs().max()) <= 1 / np.sqrt(cfg.d_model)
    assert not a.layers[1].attn["q_norm"].any() and not a.final_norm.any()
    assert a.embed.dtype == torch.bfloat16 and a.embed.shape[0] == 512


# -- the model end to end ----------------------------------------------------

_PAIRS = {}


def pair(arch: str, dtype: str):
    """(reference model, its params, the port's model with those params)."""
    key = (arch, dtype)
    if key not in _PAIRS:
        rcfg = replace(REF_SMOKES[arch], dtype=dtype)
        cfg = replace(SMOKES[arch], dtype=dtype)
        ref = ref_build(rcfg, remat="none")
        params = ref.init_params(jax.random.PRNGKey(0))
        port = build_model(cfg, device="cpu")
        port.load_state_dict(model_params_from_reference(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        _PAIRS[key] = (ref, params, port,
                       jax.jit(ref.forward), jax.jit(ref.prefill),
                       {w: jax.jit(lambda p, c, t, w=w: ref.decode(
                           p, c, t, write=w)) for w in (True, False)})
    return _PAIRS[key]


def tokens_for(cfg) -> np.ndarray:
    return np.random.default_rng(16).integers(
        0, cfg.vocab, (B, S + EXTRA)).astype(np.int32)


def pad_cache(cache: RefCache, extra: int) -> RefCache:
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return RefCache(k=jnp.pad(cache.k, pad), v=jnp.pad(cache.v, pad),
                    length=cache.length)


def close_logits(got, want, cfg, dtype):
    close(got[..., :cfg.vocab], np.asarray(want, np.float32)[..., :cfg.vocab],
          LOGIT_TOL[dtype])


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_prefill(arch, dtype):
    ref, params, port, fwd, pre, _ = pair(arch, dtype)
    cfg = port.cfg
    tok = tokens_for(cfg)
    want, _ = fwd(params, tok)
    got, aux = port.forward(torch.from_numpy(tok).long())
    assert got.shape == (B, S + EXTRA, L.pad_vocab(cfg.vocab))
    assert float(aux) == 0.0
    close_logits(got, want, cfg, dtype)
    assert (got[..., cfg.vocab:] == L.NEG_INF).all()

    want_l, want_c = pre(params, tok[:, :S])
    got_l, got_c = port.prefill(torch.from_numpy(tok[:, :S]).long())
    close_logits(got_l, want_l, cfg, dtype)
    assert got_c.k.shape == want_c.k.shape and int(got_c.length) == S
    assert got_c.length.dtype == torch.int32 and got_c.length.dim() == 0
    close(got_c.k, want_c.k, ACT_TOL[dtype])
    close(got_c.v, want_c.v, ACT_TOL[dtype])


@pytest.mark.parametrize("mode", ["write", "no_write", "write_at_capacity"])
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_three_decode_steps(mode, arch, dtype):
    """Prefill S tokens, then three decode steps against the reference's:
    ``write=True`` into a cache with room for them (the reference's cache
    padded by hand, the port's ``prefill(capacity=)``), ``write=False`` on
    the prefill's own cache, and ``write=True`` on a full cache (both
    write the last row, as dynamic_update_slice clamps)."""
    ref, params, port, _, pre, dec = pair(arch, dtype)
    cfg = port.cfg
    tok = tokens_for(cfg)
    write = mode != "no_write"
    _, rc = pre(params, tok[:, :S])
    cap = S + EXTRA if mode == "write" else None
    if mode == "write":
        rc = pad_cache(rc, EXTRA)
    _, pc = port.prefill(torch.from_numpy(tok[:, :S]).long(), capacity=cap)
    for i in range(EXTRA):
        step = tok[:, S + i:S + i + 1]
        want, rc = dec[write](params, rc, step)
        got, pc = port.decode(pc, torch.from_numpy(step).long(), write=write)
        assert got.shape == (B, L.pad_vocab(cfg.vocab))
        close_logits(got, want, cfg, dtype)
        assert int(pc.length) == int(rc.length) == S + i + 1
    close(pc.k, rc.k, ACT_TOL[dtype])
    close(pc.v, rc.v, ACT_TOL[dtype])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_continues_the_forward(arch):
    """Port alone at float32: prefill + three cached decodes give the
    forward's logits at those positions, and a pass from embeddings equals
    the pass from tokens."""
    _, _, port, _, _, _ = pair(arch, "float32")
    tok = torch.from_numpy(tokens_for(port.cfg)).long()
    full, _ = port.forward(tok)
    _, cache = port.prefill(tok[:, :S], capacity=S + EXTRA)
    for i in range(EXTRA):
        got, cache = port.decode(cache, tok[:, S + i:S + i + 1])
        close(got, full[:, S + i], dict(atol=1e-4, rtol=0))
    emb = L.embed_lookup(port.embed, tok)
    via, _ = port.forward(embeds=emb)
    assert torch.equal(via, full)
    with pytest.raises(ValueError, match="exactly one"):
        port.forward(tok, embeds=emb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_make_serve_step(dtype):
    """The serve step on the CPU: prefill on SMOKE_PREFILL's batch and a
    decode, against the reference model's prefill / decode."""
    arch = "granite-3-2b"
    ref, params, port, _, pre, dec = pair(arch, dtype)
    cfg = port.cfg
    ss = make_serve_step(cfg, SMOKE_PREFILL, device="cpu", decode_write=True,
                         capacity=SMOKE_PREFILL.seq_len + 1)
    ss.model.load_state_dict(port.state_dict())
    spec = ss.input_structs["tokens"]
    assert spec.shape == (SMOKE_PREFILL.global_batch, SMOKE_PREFILL.seq_len)
    tok = tokens_for(cfg)[:, :SMOKE_PREFILL.seq_len + 1]
    logits, cache = ss.prefill(
        {"tokens": torch.from_numpy(tok[:, :-1]).long()})
    want_l, rc = pre(params, tok[:, :-1])
    close_logits(logits, want_l, cfg, dtype)
    logits2, cache = ss.decode(cache, torch.from_numpy(tok[:, -1:]).long())
    want2, rc = dec[True](params, pad_cache(rc, 1), tok[:, -1:])
    close_logits(logits2, want2, cfg, dtype)
    close(cache.k, rc.k, ACT_TOL[dtype])
    assert ss.device == torch.device("cpu")
    with pytest.raises(NotImplementedError):
        ss.prefill({"tokens": torch.zeros((2, 4), dtype=torch.long),
                    "prefix_embeds": None})


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_serve_step_inputs_match_the_reference(shape):
    """What the serve step reads of a run, a ``ModelConfig`` and a
    ``ShapeConfig``, gives the reference's step inputs: the same names,
    shapes and dtype, shape by shape."""
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro.models.registry import input_specs as ref_input_specs
    structs, _ = ref_input_specs(REF_SMOKES["qwen3-4b"], REF_SHAPES[shape])
    got = input_specs(SMOKES["qwen3-4b"], SHAPES[shape])
    assert {k: (v.shape, str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in structs.items()}
