"""Port: the MoE family (``repro_torch/models/moe.py``, MLA in
``models/layers.py``, the dense-prefix + MoE-trunk ``TransformerLM`` with
its MTP head) against the reference on the CPU.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models``; the reference's parameters reach the port through
``convert``. Tolerances:
* routing: expert ids equal, probabilities and the aux loss within 1e-6
  (measured: below 2.4e-7; float32 routing in both dtypes: the bf16
  activations are cast to float32 before the router, as the reference
  casts them);
* the MoE and MLA layers at float32: atol 1e-5 (measured: below 8.4e-7);
  at bfloat16: atol 1e-2, rtol 2^-7 (measured: below 3.9e-3, one bf16
  ulp at 0.5, on outputs up to 3.0; one layer, so no carry from layer to
  layer as in ``test_torch_models.py``);
* the models at float32: logits, caches, aux and losses atol 1e-4
  (measured: below 2.1e-6, on losses up to 8.1);
* the dispatch branch against the gather branch on the same hidden
  states, port alone: float32 atol 1e-5 (measured: 6e-8); the gradients
  of remat="block" against remat="none": atol 1e-6 (measured: equal).
torch is pinned to one thread (as the train-half tests): at these shapes
several threads under ``-n 6`` only contend.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import build_model as ref_build
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models.transformer import KVCache as RefCache
from repro_torch import private_inference as pi
from repro_torch.configs import SMOKES, get_arch
from repro_torch.configs.shapes import SMOKE_PREFILL
from repro_torch.convert import (model_params_from_reference,
                                 tensor_from_reference)
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.runtime.steps import make_serve_step

torch.set_num_threads(1)

MOE_ARCHS = ("deepseek-v3-671b", "grok-1-314b")
DTYPES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
LAYER_TOL = {"float32": dict(atol=1e-5, rtol=0),
             "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
MODEL_TOL = dict(atol=1e-4, rtol=0)
ROUTE_TOL = dict(atol=1e-6, rtol=0)
B, S, EXTRA = 2, 32, 3


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def both(arr: np.ndarray, dtype: str):
    return (jnp.asarray(arr, JNP_DT[dtype]),
            torch.from_numpy(arr).to(TORCH_DT[dtype]))


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def cfgs(arch: str, dtype: str):
    return (replace(REF_SMOKES[arch], dtype=dtype),
            replace(SMOKES[arch], dtype=dtype))


def tree_to_port(tree):
    return {k: tree_to_port(v) if isinstance(v, dict)
            else tensor_from_reference(np.asarray(v)) for k, v in tree.items()}


def moe_params(arch: str, dtype: str, seed: int = 3):
    rcfg, cfg = cfgs(arch, dtype)
    rp = RM.moe_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, rp, tree_to_port(rp)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_resolve(arch):
    for smoke in (False, True):
        cfg = get_arch(arch, smoke=smoke)
        assert cfg.family == "moe" and cfg.moe is not None
    assert get_arch(arch).torch_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs moe="):
        build_model(replace(SMOKES[arch], moe=None), device="cpu")


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_route(arch, dtype):
    rcfg, cfg, rp, pp = moe_params(arch, dtype)
    rx, px = both(randn(1, 24, cfg.d_model), dtype)
    wp, wi, wa = RM._route(rp, rcfg, rx)
    gp, gi, ga = M._route(pp, cfg, px)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gp, wp, ROUTE_TOL)
    close(ga, wa, ROUTE_TOL)
    # a leading axis routes each group on its own (the dispatch's per
    # sequence aux)
    rx2, px2 = both(randn(2, 3, 8, cfg.d_model), dtype)
    _, gi2, ga2 = M._route(pp, cfg, px2)
    for b in range(3):
        _, wi_b, wa_b = RM._route(rp, rcfg, rx2[b])
        np.testing.assert_array_equal(gi2[b].numpy(), np.asarray(wi_b))
        close(ga2[b], wa_b, ROUTE_TOL)


def test_top_k_ties_take_the_lower_index():
    """Equal probabilities (a zero router): the reference's top_k takes
    experts 0..k-1, and so does the port (torch.topk would not)."""
    rcfg, cfg = cfgs("deepseek-v3-671b", "float32")
    rcfg = replace(rcfg, moe=replace(rcfg.moe, n_experts=16, top_k=4))
    cfg = replace(cfg, moe=replace(cfg.moe, n_experts=16, top_k=4))
    x = randn(4, 5, cfg.d_model)
    router = np.zeros((cfg.d_model, 16), np.float32)
    router[:, 9:] = randn(5, cfg.d_model, 7)       # ties among 0..8 only
    x[:2] = 0.0                                    # all 16 tie for these
    wp, wi, _ = RM._route({"router": jnp.asarray(router)}, rcfg,
                          jnp.asarray(x))
    gp, gi, _ = M._route({"router": torch.from_numpy(router)}, cfg,
                         torch.from_numpy(x))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gi[:2].numpy(), [[0, 1, 2, 3]] * 2)
    close(gp, wp, ROUTE_TOL)


# -- the FFN paths ------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dispatch(arch, dtype):
    rcfg, cfg, rp, pp = moe_params(arch, dtype)
    rx, px = both(randn(6, 3, 20, cfg.d_model), dtype)
    want, waux = RM.moe_apply_dispatch(rp, rcfg, rx)
    got, gaux = M.moe_apply_dispatch(pp, cfg, px)
    assert got.shape == px.shape and got.dtype == px.dtype
    close(got, want, LAYER_TOL[dtype])
    close(gaux, waux, ROUTE_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dispatch_drops_the_reference_slots_when_an_expert_overfills(dtype):
    """A router that sends every token's first choice to expert 0: its
    group holds S slots against a capacity of 8, so S - 8 slots a
    sequence drop, the same ones as the reference's (the stable sort keeps
    the earliest tokens)."""
    arch = "deepseek-v3-671b"
    rcfg, cfg, rp, pp = moe_params(arch, dtype)
    router = np.asarray(rp["router"]).copy()
    router[:, 0] = 1.0
    rp = {**rp, "router": jnp.asarray(router)}
    pp = {**pp, "router": torch.from_numpy(router)}
    x = np.abs(randn(7, 2, 24, cfg.d_model))       # sum(x) >> other logits
    rx, px = both(x, dtype)
    assert M.dispatch_capacity(cfg, 24) == 8
    _, top_i, _ = M._route(pp, cfg, px)
    assert (top_i[..., 0] == 0).all()
    per_expert = torch.stack([torch.bincount(t.reshape(-1), minlength=8)
                              for t in top_i])
    want_dropped = int(torch.clamp(per_expert - 8, min=0).sum())
    assert M.dropped_slots(pp, cfg, px) == want_dropped >= 2 * (24 - 8)
    want, waux = RM.moe_apply_dispatch(rp, rcfg, rx)
    got, gaux = M.moe_apply_dispatch(pp, cfg, px)
    close(got, want, LAYER_TOL[dtype])
    close(gaux, waux, ROUTE_TOL)
    # the dropped slots matter: without the capacity the output differs
    wide = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    assert M.dropped_slots(pp, wide, px) == 0
    undropped, _ = M.moe_apply_dispatch(pp, wide, px)
    assert (to_np(undropped) - to_np(got)).std() > 1e-3


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather(arch, dtype):
    rcfg, cfg, rp, pp = moe_params(arch, dtype)
    rx, px = both(randn(8, 3, 1, cfg.d_model), dtype)
    want, waux = RM.moe_apply_gather(rp, rcfg, rx)
    got, gaux = M.moe_apply_gather(pp, cfg, px)
    assert got.shape == px.shape and got.dtype == px.dtype
    close(got, want, LAYER_TOL[dtype])
    close(gaux, waux, ROUTE_TOL)


MOE_APPLY_CASES = {
    # name: (batch, seq, the branch moe_apply takes at deepseek SMOKE,
    # 8 experts top-2)
    "prefill_dispatch": (2, 12, "dispatch"),
    "decode_batch_global_dispatch": (4, 1, "global"),
    "decode_gather": (3, 1, "gather"),
}


@pytest.mark.parametrize("case", sorted(MOE_APPLY_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_apply_branches(case, dtype):
    b, s, branch = MOE_APPLY_CASES[case]
    rcfg, cfg, rp, pp = moe_params("deepseek-v3-671b", dtype)
    assert (b * cfg.moe.top_k >= cfg.moe.n_experts) == (branch == "global")
    rx, px = both(randn(9, b, s, cfg.d_model), dtype)
    want, waux = RM.moe_apply(rp, rcfg, rx)
    got, gaux = M.moe_apply(pp, cfg, px)
    assert got.shape == (b, s, cfg.d_model)
    close(got, want, LAYER_TOL[dtype])
    close(gaux, waux, ROUTE_TOL)
    direct = {"dispatch": lambda: M.moe_apply_dispatch(pp, cfg, px),
              "global": lambda: M.moe_apply_dispatch(
                  pp, cfg, px.reshape(1, b, -1)),
              "gather": lambda: M.moe_apply_gather(pp, cfg, px)}[branch]
    assert torch.equal(direct()[0].reshape(got.shape), got)


def test_decode_branches_agree_without_drops():
    """At S == 1 the batch-global dispatch and the per-token gather compute
    the same function while no slot drops (capacity 8 >= B here)."""
    _, cfg, _, pp = moe_params("deepseek-v3-671b", "float32")
    x = torch.from_numpy(randn(10, 4, 1, cfg.d_model))
    assert M.dropped_slots(pp, cfg, x.reshape(1, 4, -1)) == 0
    via_dispatch, _ = M.moe_apply_dispatch(pp, cfg, x.reshape(1, 4, -1))
    via_gather, _ = M.moe_apply_gather(pp, cfg, x)
    close(via_dispatch.reshape(x.shape), via_gather, LAYER_TOL["float32"])


def test_moe_init_draws_each_expert():
    _, cfg = cfgs("deepseek-v3-671b", "bfloat16")
    a = M.moe_init(torch.Generator().manual_seed(1), cfg)
    b = M.moe_init(torch.Generator().manual_seed(1), cfg)
    assert a["router"].dtype == torch.float32
    assert a["gate"].shape == (8, 64, 32) and a["down"].shape == (8, 32, 64)
    assert a["gate"].dtype == torch.bfloat16
    assert float(a["gate"].float().abs().max()) <= 1 / np.sqrt(64)
    assert float(a["down"].float().abs().max()) <= 1 / np.sqrt(32)
    assert not torch.equal(a["gate"][0], a["gate"][1])
    for k in ("router", "gate", "up", "down"):
        assert torch.equal(a[k], b[k])
    assert a["shared"]["gate"].shape == (64, 32)


# -- MLA ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_and_absorbed_decode(dtype):
    rcfg, cfg = cfgs("deepseek-v3-671b", dtype)
    rp = RL.mla_init(jax.random.PRNGKey(11), rcfg)
    pp = tree_to_port(rp)
    rx, px = both(randn(12, 2, 32, cfg.d_model), dtype)
    pos = np.arange(32)[None, :]
    rout, rrow = RL.mla_attend(rp, rcfg, rx, jnp.asarray(pos))
    pout, prow = L.mla_attend(pp, cfg, px, torch.from_numpy(pos))
    m = cfg.mla
    assert pout.shape == (2, 32, cfg.d_model)
    assert prow.shape == (2, 32, m.kv_lora_rank + m.qk_rope_head_dim)
    close(pout, rout, LAYER_TOL[dtype])
    close(prow, rrow, LAYER_TOL[dtype])
    # decode at position 20 against a cache of 32 rows, 20 of them valid
    rc, pc = both(randn(13, 2, 32, m.kv_lora_rank + m.qk_rope_head_dim),
                  dtype)
    rx1, px1 = both(randn(14, 2, 1, cfg.d_model), dtype)
    p1 = np.asarray([[20]])
    rout1, rrow1 = RL.mla_attend(rp, rcfg, rx1, jnp.asarray(p1),
                                 kv_cache=rc, kv_len=jnp.asarray(20))
    for kv_len in (20, torch.tensor(20)):
        pout1, prow1 = L.mla_attend(pp, cfg, px1, torch.from_numpy(p1),
                                    kv_cache=pc, kv_len=kv_len)
        close(pout1, rout1, LAYER_TOL[dtype])
        close(prow1, rrow1, LAYER_TOL[dtype])
    with pytest.raises(ValueError, match="single-token"):
        L.mla_attend(pp, cfg, px, torch.from_numpy(pos), kv_cache=pc,
                     kv_len=20)


# -- the model end to end -----------------------------------------------------

_PAIRS = {}


def pair(arch: str):
    """(reference model, its params, the port's model with those params,
    jitted forward / prefill / decode / loss) at float32."""
    if arch not in _PAIRS:
        rcfg, cfg = cfgs(arch, "float32")
        ref = ref_build(rcfg, remat="none")
        params = ref.init_params(jax.random.PRNGKey(0))
        port = build_model(cfg, device="cpu")
        port.load_state_dict(model_params_from_reference(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        _PAIRS[arch] = (ref, params, port, jax.jit(ref.forward),
                        jax.jit(ref.prefill),
                        {w: jax.jit(lambda p, c, t, w=w: ref.decode(
                            p, c, t, write=w)) for w in (True, False)},
                        jax.jit(ref.loss))
    return _PAIRS[arch]


def tokens_for(cfg) -> np.ndarray:
    return np.random.default_rng(16).integers(
        0, cfg.vocab, (B, S + EXTRA)).astype(np.int32)


def close_logits(got, want, cfg):
    close(got[..., :cfg.vocab], np.asarray(want, np.float32)[..., :cfg.vocab],
          MODEL_TOL)


def pad_cache(cache: RefCache, extra: int, mla: bool) -> RefCache:
    pad = [(0, 0), (0, 0), (0, extra)] + [(0, 0)] * (2 - mla)
    return RefCache(k=jnp.pad(cache.k, pad),
                    v=cache.v if mla else jnp.pad(cache.v, pad),
                    length=cache.length)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_layout(arch):
    _, params, port, *_ = pair(arch)
    cfg = port.cfg
    assert port.n_dense == cfg.moe.first_dense
    assert len(port.layers) == port.n_dense
    assert len(port.moe_layers) == cfg.n_layers - cfg.moe.first_dense
    names = dict(port.named_parameters())
    if arch == "deepseek-v3-671b":
        assert names["layers.0.ffn.gate"].shape == (64, 96)  # dense_d_ff
        assert names["moe_layers.1.ffn.shared.down"].shape == (32, 64)
        assert names["mtp.proj"].shape == (128, 64)
        assert "mtp.layer.attn.wkv_b" in names
        assert names["moe_layers.0.attn.wkv_b"].shape == (16, 4 * 32)
    else:
        assert port.n_dense == 0 and port.mtp is None
        assert names["moe_layers.1.ffn.gate"].shape == (4, 64, 64)
    assert names["moe_layers.0.ffn.router"].dtype == torch.float32
    n_ref = sum(np.asarray(a).size
                for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_ref


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_and_loss(arch):
    ref, params, port, fwd, pre, _, loss = pair(arch)
    cfg = port.cfg
    tok = tokens_for(cfg)
    want, waux = fwd(params, tok)
    got, gaux = port.forward(torch.from_numpy(tok).long())
    assert got.shape == (B, S + EXTRA, L.pad_vocab(cfg.vocab))
    close_logits(got, want, cfg)
    assert float(gaux) > 0
    close(gaux, waux, MODEL_TOL)

    want_l, want_c = pre(params, tok[:, :S])
    got_l, got_c = port.prefill(torch.from_numpy(tok[:, :S]).long())
    close_logits(got_l, want_l, cfg)
    assert got_c.k.shape == want_c.k.shape and int(got_c.length) == S
    close(got_c.k, want_c.k, MODEL_TOL)
    if cfg.mla is not None:
        assert got_c.v.shape == (cfg.n_layers, B, 0)
    else:
        close(got_c.v, want_c.v, MODEL_TOL)

    wt, wm = loss(params, tok)
    gt, gm = port.loss(torch.from_numpy(tok))
    close(gt, wt, MODEL_TOL)
    assert gm.keys() == wm.keys()
    assert ("mtp_ce" in gm) == cfg.mtp
    for k in gm:
        close(gm[k], wm[k], MODEL_TOL)


@pytest.mark.parametrize("mode", ["write", "no_write", "write_at_capacity"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_three_decode_steps(mode, arch):
    """Prefill S tokens, then three decode steps against the reference's
    (deepseek SMOKE at B = 2 takes the gather branch, grok SMOKE the
    batch-global dispatch): ``write=True`` into a cache with room (the
    reference's padded by hand), ``write=False`` on the prefill's own,
    and ``write=True`` on a full cache (both write the last row)."""
    ref, params, port, _, pre, dec, _ = pair(arch)
    cfg = port.cfg
    mla = cfg.mla is not None
    tok = tokens_for(cfg)
    write = mode != "no_write"
    _, rc = pre(params, tok[:, :S])
    cap = S + EXTRA if mode == "write" else None
    if mode == "write":
        rc = pad_cache(rc, EXTRA, mla)
    _, pc = port.prefill(torch.from_numpy(tok[:, :S]).long(), capacity=cap)
    for i in range(EXTRA):
        step = tok[:, S + i:S + i + 1]
        want, rc = dec[write](params, rc, step)
        got, pc = port.decode(pc, torch.from_numpy(step).long(), write=write)
        close_logits(got, want, cfg)
        assert int(pc.length) == int(rc.length) == S + i + 1
    close(pc.k, rc.k, MODEL_TOL)


def test_remat_covers_both_stacks():
    """With grad enabled, remat="block" recomputes every block of both
    stacks and gives the gradients of remat="none"."""
    _, _, port, *_ = pair("deepseek-v3-671b")
    cfg = port.cfg
    tok = torch.from_numpy(tokens_for(cfg)[:, :16]).long()
    grads = {}
    for remat in ("none", "block"):
        model = build_model(cfg, device="cpu", remat=remat)
        model.load_state_dict(port.state_dict())
        model.requires_grad_(True)
        loss, _ = model.loss(tok)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads["none"], grads["block"]):
        close(b, a, dict(atol=1e-6, rtol=0))
    names = [n for n, _ in port.named_parameters()]
    moved = {n for n, g in zip(names, grads["block"]) if g.abs().sum() > 0}
    assert any(n.startswith("moe_layers.1.ffn.gate") for n in moved)
    assert "mtp.proj" in moved and "layers.0.attn.wq_a" in moved


def test_make_serve_step_moe():
    """The serve step on the CPU at grok SMOKE: prefill and a decode
    against the reference model's."""
    ref, params, port, _, pre, dec, _ = pair("grok-1-314b")
    cfg = port.cfg
    shape = SMOKE_PREFILL
    ss = make_serve_step(cfg, shape, device="cpu", decode_write=True,
                         capacity=shape.seq_len + 1)
    ss.model.load_state_dict(port.state_dict())
    tok = np.random.default_rng(17).integers(
        0, cfg.vocab, (shape.global_batch, shape.seq_len + 1)).astype(np.int32)
    logits, cache = ss.prefill(
        {"tokens": torch.from_numpy(tok[:, :-1]).long()})
    want_l, rc = pre(params, tok[:, :-1])
    close_logits(logits, want_l, cfg)
    logits2, cache = ss.decode(cache, torch.from_numpy(tok[:, -1:]).long())
    want2, rc = dec[True](params, pad_cache(rc, 1, False), tok[:, -1:])
    close_logits(logits2, want2, cfg)


def test_private_twin_on_deepseek_smoke():
    """``python -m repro_torch.private_inference --arch deepseek-v3-671b
    --smoke``: rows bit-exact, tokens those of plain lookups, the MLA
    cache sliced for the solo step."""
    out = pi.run(device="cpu", arch="deepseek-v3-671b", smoke=True,
                 tokens=3, streams=2, seed=4, verbose=False)
    assert out["arch"] == "deepseek-v3-671b-smoke"
    assert out["rows_exact"] and out["plain_equal"]
    assert [c["queries"] for c in out["pir_calls"]] == [6, 2, 2, 1]
    assert np.asarray(out["streams"]).shape == (2, 6)
