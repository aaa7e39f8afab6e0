"""Mixture-of-experts FFN with sort-based capacity dispatch — the port of
``repro/models/moe.py``.

Two execution paths, as the reference's:

``dispatch`` (train / prefill; decode at serving batches)
    Per-sequence sort-based dispatch: each sequence's (token, expert)
    slots are sorted by expert id, packed into a capacity-bounded buffer
    ``[B, E, C, d]`` by gathers, run through one batched GEMM per expert
    weight (the experts as the batch), and combined back to token order.
    A slot past its expert's capacity is dropped. Every sequence is
    handled at once (batched sorts, searches and gathers), never in a
    loop over sequences.

``gather`` (decode at small batches)
    Each token gathers its top-k experts' weight slices, ``[T, K, d, f]``
    per weight: the reference's algorithm, kept as it is (it copies the
    gathered slices).

:func:`moe_apply` picks between them as the reference does.

Router: a softmax over the experts in float32, the top k taken by a
stable descending sort, renormalised; the Switch-style load-balance loss
is returned for the training objective. The sort is stable where the
reference's is: of equal probabilities the lower expert index is taken
first, as ``jax.lax.top_k`` takes it (``torch.topk`` breaks ties
otherwise), and the slots are ordered by expert with ``stable=True``, as
``jnp.argsort`` orders them, so that a full expert drops the same slots.

Parameters are a mapping of name -> tensor: ``router`` ``[d, E]``
float32, ``gate`` / ``up`` ``[E, d, f]`` and ``down`` ``[E, f, d]`` in
the config dtype, and, with shared experts, ``shared`` ``{gate, up,
down}`` (a dense SwiGLU of width ``n_shared * f``). ``transformer.MoE``
holds them for a layer.

Left out: ``moe_specs`` and ``shard_hint`` (mesh layout; expert
parallelism over several cards is ROADMAP A6b).
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

F32 = torch.float32

Params = Mapping[str, object]


def moe_init(gen: torch.Generator, cfg) -> dict:
    """The reference's ``moe_init`` tree, drawn from ``gen`` on its
    device."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    dt = cfg.torch_dtype
    p = {"router": dense_init(gen, d, e, F32),
         "gate": _expert_init(gen, e, d, f, dt),
         "up": _expert_init(gen, e, d, f, dt),
         "down": _expert_init(gen, e, f, d, dt)}
    if m.n_shared:
        ff = m.n_shared * f
        p["shared"] = {"gate": dense_init(gen, d, ff, dt),
                       "up": dense_init(gen, d, ff, dt),
                       "down": dense_init(gen, ff, d, dt)}
    return p


def _expert_init(gen: torch.Generator, e: int, d_in: int, d_out: int,
                 dt: torch.dtype) -> torch.Tensor:
    w = torch.empty((e, d_in, d_out), dtype=dt, device=gen.device)
    return init_experts_(w, gen)


def init_experts_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill ``w`` ``[E, d_in, d_out]`` in place, uniform in
    ``±1/sqrt(d_in)``, drawn in float32 one expert at a time (all of
    deepseek-v3's 256 at once would be a 15 GB float32 draw) and cast to
    ``w``'s dtype. Returns ``w``."""
    d_in = w.shape[1]
    scale = 1.0 / math.sqrt(d_in)
    one = torch.empty(w.shape[1:], dtype=F32, device=w.device)
    for i in range(w.shape[0]):
        w[i] = one.uniform_(-scale, scale, generator=gen)
    return w


def _route(params: Params, cfg, x: torch.Tensor):
    """Top-k routing of the tokens of ``x`` ``[..., T, d]``: (probs
    ``[..., T, K]``, expert ids ``[..., T, K]``, aux loss ``[...]``), each
    leading index a routing group of its own (a sequence, or the decode
    batch)."""
    m = cfg.moe
    logits = x.to(F32) @ params["router"].to(F32)            # [..., T, E]
    probs_full = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs_full, dim=-1, descending=True,
                              stable=True)
    top_p, top_i = top_p[..., :m.top_k], top_i[..., :m.top_k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance auxiliary: E * sum_e f_e * p_e
    t = x.shape[-2]
    flat = top_i.reshape(*top_i.shape[:-2], -1)
    density = torch.zeros(flat.shape[:-1] + (m.n_experts,), dtype=F32,
                          device=x.device)
    density.scatter_add_(-1, flat, torch.full(flat.shape, 1.0 / (
        t * m.top_k), dtype=F32, device=x.device))
    mean_p = probs_full.mean(dim=-2)
    aux = m.n_experts * (density * mean_p).sum(dim=-1)
    return top_p, top_i, aux


def _expert_ffn(params: Params, buf: torch.Tensor) -> torch.Tensor:
    """buf ``[..., E, C, d]`` -> ``[..., E, C, d]`` through per-expert
    SwiGLU: the slots of every leading index grouped by expert, one
    ``bmm`` per weight."""
    *lead, e, c, d = buf.shape
    xs = buf.reshape(-1, e, c, d).transpose(0, 1).reshape(e, -1, d)
    h = F.silu(torch.bmm(xs, params["gate"])) * torch.bmm(xs, params["up"])
    y = torch.bmm(h, params["down"])                          # [E, N*C, d]
    return y.reshape(e, -1, c, d).transpose(0, 1).reshape(*lead, e, c, d)


def dispatch_capacity(cfg, tokens: int) -> int:
    """Slots per expert of a dispatch group of ``tokens`` tokens."""
    m = cfg.moe
    tk = tokens * m.top_k
    capacity = max(8, int(math.ceil(tk / m.n_experts * m.capacity_factor)))
    return min(capacity, tk)


def moe_apply_dispatch(params: Params, cfg, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch. x: ``[B, S, d]`` -> (``[B, S, d]``,
    aux: the mean of the sequences' aux losses)."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.top_k, m.n_experts
    tk = s * k
    capacity = dispatch_capacity(cfg, s)
    dev = x.device
    top_p, top_i, aux = _route(params, cfg, x)             # [B, S, K], [B]
    flat_e = top_i.reshape(b, tk)
    flat_p = top_p.reshape(b, tk)
    flat_t = torch.arange(s, device=dev).repeat_interleave(k)   # source
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sp = torch.gather(flat_p, 1, order)
    st = flat_t[order]
    # rank within the expert's group
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    group_start = torch.searchsorted(se, experts, right=False)    # [B, E]
    pos = torch.arange(tk, device=dev) - torch.gather(group_start, 1, se)
    keep = pos < capacity
    # pack [B, E, C, d] by gather: slot (e, c) reads sorted slot
    # group_start[e] + c, zero where that overruns e's group
    slot_src = group_start[..., None] + torch.arange(capacity, device=dev)
    group_end = torch.cat([group_start[:, 1:], torch.full(
        (b, 1), tk, dtype=group_start.dtype, device=dev)], dim=1)
    slot_valid = slot_src < group_end[..., None]            # [B, E, C]
    tok_for_slot = torch.gather(st, 1, slot_src.clamp(0, tk - 1).reshape(
        b, e * capacity))
    base = torch.arange(b, device=dev)[:, None]
    buf = x.reshape(b * s, d).index_select(
        0, (tok_for_slot + base * s).reshape(-1)).reshape(b, e, capacity, d)
    buf.masked_fill_(~slot_valid[..., None], 0)
    out_buf = _expert_ffn(params, buf)                      # [B, E, C, d]
    # combine back: sorted slot i lives in (se[i], pos[i])
    back = out_buf.reshape(b * e * capacity, d).index_select(0, (
        (base * e + se) * capacity + pos.clamp(0, capacity - 1)).reshape(-1)
    ).reshape(b, tk, d)
    back.masked_fill_(~keep[..., None], 0)
    back = back * sp[..., None].to(x.dtype)
    # token t's K slots are contiguous in the inverse permutation
    inv = torch.argsort(st * tk + torch.arange(tk, device=dev), dim=-1)
    out = back.reshape(b * tk, d).index_select(
        0, (inv + base * tk).reshape(-1)).reshape(b, s, k, d).sum(dim=2)
    if "shared" in params:
        out = out + _shared_ffn(params["shared"], x)
    return out.to(x.dtype), aux.mean()


def dropped_slots(params: Params, cfg, x: torch.Tensor) -> int:
    """The (token, expert) slots that :func:`moe_apply_dispatch` drops on
    ``x`` ``[B, S, d]``: per sequence and expert, those routed past its
    capacity."""
    b, s, _ = x.shape
    _, top_i, _ = _route(params, cfg, x)
    flat = top_i.reshape(b, -1)
    counts = torch.zeros((b, cfg.moe.n_experts), dtype=torch.int64,
                         device=x.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    return int(torch.clamp(counts - dispatch_capacity(cfg, s), min=0).sum())


def moe_apply_gather(params: Params, cfg, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode path: each token gathers its top-k experts' weight slices.
    x ``[B, S, d]`` (S = 1 at decode) -> (``[B, S, d]``, aux)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    top_p, top_i, aux = _route(params, cfg, x_flat)          # [T, K]
    xk = x_flat[:, None, None, :]                            # [T, 1, 1, d]
    h = F.silu(xk @ params["gate"][top_i]) * (xk @ params["up"][top_i])
    y = (h @ params["down"][top_i])[:, :, 0]                 # [T, K, d]
    out = torch.sum(y * top_p[..., None].to(y.dtype), dim=1).reshape(b, s, d)
    if "shared" in params:
        out = out + _shared_ffn(params["shared"], x)
    return out.to(x.dtype), aux


def _shared_ffn(sp: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ sp["gate"]) * (x @ sp["up"])) @ sp["down"]


def moe_apply(params: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route to the right execution shape, as the reference:

    * S > 1 (train / prefill): per-sequence dispatch.
    * S == 1 and B·top_k >= E (decode at serving batches): batch-global
      dispatch, all B tokens one group, so each expert's weights are read
      once per layer.
    * smaller decode batches: the per-token gather (at most B·K experts
      read).
    """
    m = cfg.moe
    if x.shape[1] == 1:
        b = x.shape[0]
        if b * m.top_k >= m.n_experts:
            y, aux = moe_apply_dispatch(params, cfg,
                                        x.reshape(1, b, x.shape[2]))
            return y.reshape(b, 1, x.shape[2]), aux
        return moe_apply_gather(params, cfg, x)
    return moe_apply_dispatch(params, cfg, x)
