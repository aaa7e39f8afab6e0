"""Port: the hybrid family's serving path (zamba2-7b ``SMOKE``,
``Zamba2Model``) against the reference's ``repro.models.hybrid`` on the
CPU — the parameter tree through ``convert``, ``forward``, ``loss``,
``prefill`` with every cache field (at a capacity above the prompt too),
decode chains with ``write=True`` and ``write=False``, ``embeds=`` and
``remat`` (the serve step and the twin: ``test_torch_zamba2_serve.py``).

SMOKE has 5 Mamba layers and the shared block every 2: two invocations
(after layers 2 and 4) with one weight copy and a KV cache each, and a
tail of one layer with no shared block after it.

The reference's weights (``PRNGKey(0)``) reach the port through
``convert.model_params_from_reference`` bit for bit (``a_log``,
``dt_bias``, ``d_skip`` float32 in the bf16 model too); tokens come from
numpy seeds. Tolerances, each with what was measured:
* float32: logits atol 1e-5 (measured at most 7.5e-7 on logits of
  magnitude 0.81), each cache field within 1e-5 of the reference's
  largest magnitude (measured 1.3e-6 of it), the loss rtol 1e-6 (measured
  0);
* bfloat16: logits atol 2^-4 (eight bf16 ulps at 1.0; measured at most
  0.0261: the SiLUs round otherwise than XLA's, by up to two ulps
  (``tests/test_torch_zamba2.py``), and five Mamba layers and two
  shared-block invocations carry it on), each cache field within 2^-3 of
  the reference's largest magnitude in that field (measured at most
  2^-5.3 on the conv tails and KV caches, 2^-4.6 on the float32 SSD
  states, which sum bf16 inputs over the prompt), the loss atol 2e-2
  (measured 1.3e-4);
* port against port (decode against the forward, ``remat``, ``embeds=``):
  float32 atol 1e-5 (measured 4.2e-7), or exact where the same operations
  run.
torch is pinned to one thread.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import build_model as ref_build
from repro.models.hybrid import HybridCache as RefCache
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.convert import leaf_paths, model_params_from_reference
from repro_torch.models import Zamba2Model, build_model
from repro_torch.models import layers as L
from repro_torch.models.hybrid import HybridCache

ARCH = "zamba2-7b"
DTYPES = ("float32", "bfloat16")
B = 2
S = 16
EXTRA = 5
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 2 ** -4}
FIELD_REL = {"float32": 1e-5, "bfloat16": 2 ** -3}
LOSS_TOL = {"float32": dict(rtol=1e-6, atol=0),
            "bfloat16": dict(rtol=0, atol=2e-2)}
FIELDS = ("conv", "state", "attn_k", "attn_v")


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
    params, jitted reference forward / prefill / decode by ``write``),
    once a dtype."""
    if dtype not in _PAIRS:
        ref = ref_build(replace(REF_SMOKES[ARCH], dtype=dtype),
                        remat="none")
        params = jax.tree_util.tree_map(
            np.asarray, ref.init_params(jax.random.PRNGKey(0)))
        port = build_model(replace(SMOKES[ARCH], dtype=dtype), device="cpu")
        port.load_state_dict(model_params_from_reference(params, port.cfg))
        dec = {w: jax.jit(lambda p, c, t, w=w: ref.decode(p, c, t, write=w))
               for w in (True, False)}
        _PAIRS[dtype] = (ref, params, port, jax.jit(ref.forward),
                         jax.jit(ref.prefill), dec)
    return _PAIRS[dtype]


def logits_close(got, want, dtype):
    v = SMOKES[ARCH].vocab
    np.testing.assert_allclose(as_np(got)[..., :v], as_np(want)[..., :v],
                               rtol=0, atol=LOGIT_ATOL[dtype])


def cache_close(got: HybridCache, want, dtype, rows=None):
    """Every field of the cache against the reference's (the KV caches'
    first ``rows`` rows where given), each within ``FIELD_REL`` of the
    reference's largest magnitude, with its shape and dtype."""
    assert int(got.length) == int(want.length)
    assert got.length.dtype == torch.int32 and got.length.dim() == 0
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if rows is not None and f.startswith("attn"):
            g = g[:, :, :rows]
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).split(".")[-1] == str(w.dtype), f
        w = as_np(w)
        np.testing.assert_allclose(as_np(g), w, rtol=0, err_msg=f,
                                   atol=FIELD_REL[dtype] * np.abs(w).max())


def pad_cache(cache: RefCache, extra: int) -> RefCache:
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return cache._replace(attn_k=jnp.pad(cache.attn_k, pad),
                          attn_v=jnp.pad(cache.attn_v, pad))


# -- the parameter tree and the model -----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_parameter_paths_are_the_reference_tree(dtype):
    """Every leaf of the reference's tree is one parameter of the port's
    module (``mamba_layers/mix/a_log`` [L, H] -> ``mamba_layers.{i}.mix.
    a_log``, ``shared/attn/wq`` -> ``shared.attn.wq``) with the same
    shape, dtype and bits; the shared block is one copy."""
    _, params, port, *_ = pair(dtype)
    state = model_params_from_reference(params, port.cfg)
    mine = port.state_dict()
    assert state.keys() == mine.keys()
    n_stacked = sum(1 for k, _ in leaf_paths(params)
                    if k.startswith("mamba_layers/"))
    assert len(state) == len(dict(leaf_paths(params))) + n_stacked * 4
    for k, v in state.items():
        assert v.dtype == mine[k].dtype and v.shape == mine[k].shape, k
        assert torch.equal(v, mine[k]), k
    for name in ("a_log", "dt_bias", "d_skip"):
        assert state[f"mamba_layers.4.mix.{name}"].dtype == torch.float32
    assert state["mamba_layers.0.mix.in_proj"].dtype == port.cfg.torch_dtype
    assert set(port.shared.attn) == {"wq", "wk", "wv", "wo"}
    assert set(port.shared.mlp) == {"gate", "up", "down"}
    assert not any(k.startswith("shared.") and ".0." in k for k in mine)


def test_build_model_serves_the_hybrid_family():
    """``build_model`` gives a Zamba2Model; SMOKE has 2 groups and a tail
    of 1, FULL (on the meta device) 13 groups of 6 and a tail of 3 and
    6.75 B parameters: the config's analytic count (which counts two
    d-wide norms a layer) plus the norms and per-head vectors it leaves
    out. A hybrid config without ``ssm=`` is refused, and an unknown
    family raises."""
    model = build_model(SMOKES[ARCH], device="cpu")
    assert isinstance(model, Zamba2Model) and model.device.type == "cpu"
    assert (model.every, model.n_groups, model.tail) == (2, 2, 1)
    assert model.embed.shape == (L.pad_vocab(512), 64)
    full = Zamba2Model(ARCHS[ARCH], device="meta")
    assert (full.every, full.n_groups, full.tail) == (6, 13, 3)
    n = sum(p.numel() for p in full.parameters())
    d, d_inner, heads = 3584, 7168, 112
    assert n == ARCHS[ARCH].n_params() - 81 * 2 * d + 81 * (
        d + d_inner + 3 * heads) + 2 * d + d == 6_750_539_856
    with pytest.raises(ValueError, match="ssm="):
        Zamba2Model(replace(SMOKES[ARCH], ssm=None), device="cpu")
    with pytest.raises(ValueError, match="ssm="):
        build_model(replace(SMOKES[ARCH], ssm=None), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(replace(SMOKES[ARCH], family="mystery"), device="cpu")


def test_init_params_from_a_generator():
    """The reference's distributions, drawn on the module's device: the
    tables normal x 0.02, norms zero, Mamba2's float32 ``a_log`` 0,
    ``dt_bias`` log(e - 1), ``d_skip`` 1; the same seed draws the same
    weights."""
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
    assert not m1.final_norm.any() and not m1.mamba_layers[0].norm.any()
    assert not m1.shared.ln1.any() and not m1.shared.ln2.any()
    mix = m1.mamba_layers[3].mix
    assert mix["a_log"].dtype == torch.float32 and not mix["a_log"].any()
    assert torch.allclose(mix["dt_bias"], torch.tensor(np.log(np.e - 1),
                                                       dtype=torch.float32))
    assert (mix["d_skip"] == 1).all()


# -- forward, loss, prefill, decode -----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_the_reference(dtype):
    """Logits over 32 tokens (two chunks of 16) and the zero aux; the
    padding rows masked."""
    _, params, port, fwd, *_ = pair(dtype)
    tok = tokens_for(32)
    want, waux = fwd(params, tok)
    got, aux = port.forward(torch.from_numpy(tok).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(waux) == 0.0
    logits_close(got, want, dtype)
    assert (got[..., SMOKES[ARCH].vocab:] == L.NEG_INF).all()


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", [None, S + 7], ids=["exact", "room"])
def test_prefill_matches_the_reference(dtype, capacity):
    """The prefill's last logits and every cache field: the 5 layers' conv
    tails and SSD states, both invocations' KV caches (their first S rows
    at a capacity above S, the rest zero) and the length."""
    _, params, port, _, pre, _ = pair(dtype)
    tok = tokens_for(S, seed=7)
    want, wcache = pre(params, tok)
    got, cache = port.prefill(torch.from_numpy(tok).long(),
                              capacity=capacity)
    assert isinstance(cache, HybridCache)
    logits_close(got, want, dtype)
    cache_close(cache, wcache, dtype, rows=S)
    cap = S if capacity is None else capacity
    assert cache.attn_k.shape == (2, B, cap, 4, 16)
    assert not cache.attn_k[:, :, S:].any() and not cache.attn_v[:, :, S:].any()
    with pytest.raises(ValueError, match="capacity"):
        port.prefill(torch.from_numpy(tok).long(), capacity=S - 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["write", "no_write", "write_at_capacity",
                                  "alternate"])
def test_decode_chain_matches_the_reference(dtype, mode):
    """Prefill S tokens, then five decode steps against the reference's:
    ``write=True`` into KV caches with room (the reference's padded by
    hand, the port's ``prefill(capacity=)``), ``write=False`` on the
    prefill's own cache (the Mamba states advance, the KV caches stay),
    ``write=True`` on full caches (both write the last row, as
    dynamic_update_slice clamps), and the two alternating with room. Each
    step's logits, then every cache field."""
    _, params, port, _, pre, dec = pair(dtype)
    tok = tokens_for(S + EXTRA, seed=9)
    _, rc = pre(params, tok[:, :S])
    room = mode in ("write", "alternate")
    if room:
        rc = pad_cache(rc, EXTRA)
    _, pc = port.prefill(torch.from_numpy(tok[:, :S]).long(),
                         capacity=S + EXTRA if room else None)
    for i in range(EXTRA):
        write = (mode != "no_write" if mode != "alternate"
                 else i % 2 == 0)
        step = tok[:, S + i:S + i + 1]
        want, rc = dec[write](params, rc, step)
        got, pc = port.decode(pc, torch.from_numpy(step).long(),
                              write=write)
        assert got.shape == (B, L.pad_vocab(SMOKES[ARCH].vocab))
        logits_close(got, want, dtype)
    cache_close(pc, rc, dtype)
    assert int(pc.length) == S + EXTRA


def test_decode_continues_the_forward_and_keeps_the_given_states():
    """float32: a prefill over 16 tokens and 16 decode steps with
    ``write=True`` give the forward's logits over 32; a decode returns new
    Mamba states (the given ones unchanged) and, with ``write=False``,
    leaves the KV caches as they were; a stream's slice of the cache (every
    field ``[Layers, B, ...]``) decodes as that stream's row."""
    _, _, port, *_ = pair("float32")
    tok = torch.from_numpy(tokens_for(32, seed=8)).long()
    full, _ = port.forward(tok)
    logits, cache = port.prefill(tok[:, :16], capacity=32)
    torch.testing.assert_close(logits, full[:, 15], rtol=0, atol=1e-5)
    for i in range(16, 32):
        before = [t.clone() for t in cache[:4]]
        if i == 20:
            peek, same = port.decode(cache, tok[:, i:i + 1], write=False)
            assert all(torch.equal(a, b) for a, b in zip(before, cache[:4]))
            assert same.attn_k is cache.attn_k and int(same.length) == i + 1
            one, _ = port.decode(cache._replace(**{
                f: getattr(cache, f)[:, 1:2] for f in FIELDS}),
                tok[1:2, i:i + 1], write=False)
            torch.testing.assert_close(one[0], peek[1], rtol=0, atol=1e-6)
        logits, new = port.decode(cache, tok[:, i:i + 1], write=True)
        assert torch.equal(before[0], cache.conv)
        assert torch.equal(before[1], cache.state)
        assert new.attn_k is cache.attn_k
        torch.testing.assert_close(logits, full[:, i], rtol=0, atol=1e-5)
        cache = new
    assert int(cache.length) == 32


def test_weight_sharing_and_one_kv_cache_per_invocation():
    """The two invocations read one set of weights but write their own
    KV caches: the caches differ, and each equals the rows of that
    invocation's input (a hook on the shared block's attention)."""
    _, _, port, *_ = pair("float32")
    tok = torch.from_numpy(tokens_for(S, seed=11)).long()
    seen = []
    orig = port._shared_block

    def spy(x, positions, **kw):
        out = orig(x, positions, **kw)
        seen.append(out[1])
        return out

    port._shared_block = spy
    try:
        _, cache = port.prefill(tok)
    finally:
        del port._shared_block
    assert len(seen) == port.n_groups == 2
    for g, (k, v) in enumerate(seen):
        assert torch.equal(cache.attn_k[g], k)
        assert torch.equal(cache.attn_v[g], v)
    assert not torch.equal(cache.attn_k[0], cache.attn_k[1])


def test_cache_shapes_and_bytes():
    """``init_cache(B, capacity)``: the reference's shapes and dtypes; the
    Mamba states' bytes the same at 16 and 524,288 positions, the KV
    caches' 2 · g · C · KV · hd · 2 B; zero, length 0."""
    ref, _, port, *_ = pair("bfloat16")
    for cap in (16, 1024):
        want = jax.eval_shape(lambda: ref.init_cache(B, cap))
        got = port.init_cache(B, cap)
        assert [(tuple(getattr(got, f).shape),
                 str(getattr(got, f).dtype).split(".")[-1])
                for f in got._fields] == \
            [(getattr(want, f).shape, str(getattr(want, f).dtype))
             for f in want._fields]
        assert int(got.length) == 0 and not any(t.any() for t in got[:4])
    small = port.init_cache(1, 16)
    big = Zamba2Model(SMOKES[ARCH], device="meta").init_cache(1, 524_288)
    mamba = lambda c: sum(t.numel() * t.element_size()
                          for t in (c.conv, c.state))
    assert mamba(small) == mamba(big) == 5 * (3 * 160 * 2
                                              + 8 * 16 * 16 * 4)
    assert big.nbytes() - mamba(big) == 2 * 2 * 524_288 * 4 * 16 * 2


def test_embeds_in_place_of_tokens():
    """``embeds=`` (the table's rows) give the token path's logits and
    cache exactly; both or neither raise."""
    _, _, port, *_ = pair("bfloat16")
    tok = torch.from_numpy(tokens_for(16, seed=3)).long()
    rows = port.embed[tok]
    a, _ = port.forward(tok)
    b, _ = port.forward(embeds=rows)
    assert torch.equal(a, b)
    la, ca = port.prefill(tok, capacity=20)
    lb, cb = port.prefill(embeds=rows, capacity=20)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    da, _ = port.decode(ca, tok[:, :1])
    db, _ = port.decode(cb, embeds=rows[:, :1])
    assert torch.equal(da, db)
    with pytest.raises(ValueError, match="exactly one"):
        port.forward(tok, embeds=rows)
    with pytest.raises(ValueError, match="exactly one"):
        port.prefill()


def test_remat_none_against_block():
    """float32: the loss and every gradient with ``remat="block"`` (each
    Mamba layer recomputed in the backward pass) equal ``"none"``'s."""
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
