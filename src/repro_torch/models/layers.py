"""Shared model primitives of the LM: norms, RoPE, chunked attention,
the GQA and MLA blocks, the SwiGLU MLP, embeddings — the port of
``repro/models/layers.py``.

Conventions, as the reference's:
* Parameters are mappings of name -> tensor (a ``dict``, or the
  ``nn.ParameterDict`` of a ``transformer.Block``), weights in the
  ``x @ W`` orientation (``[d_in, d_out]``).
* Activations flow in the config dtype (bf16 by default); norm, RoPE and
  softmax statistics, attention scores and the unembedding are computed in
  float32 and cast back at the reference's points.
* Attention is flash-style: an online softmax over KV blocks (and Q
  blocks), so the score matrix never exceeds ``[B, H, q_chunk, kv_chunk]``.
  It is plain PyTorch (no fused attention kernel): the reference computes
  it outside any Pallas kernel.

MLA (DeepSeek's multi-head latent attention) caches one compressed row
per token, ``[kv_lora + rope]``; its prefill expands the latent to keys
and values and runs :func:`chunked_attention`, its decode attends in the
latent space ("absorbed": the query folded through ``wkv_b``'s key half,
the output latent expanded through its value half).

Left out: ``shard_hint`` and the ``*_specs`` functions (mesh layout, with
no counterpart on one card).
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32

NEG_INF = -1e30

Params = Mapping[str, torch.Tensor]
Length = Union[int, torch.Tensor]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``[d_in, d_out]`` uniform in ``±1/sqrt(d_in)``, drawn in float32 on
    the generator's device and cast to ``dtype``."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=F32, device=gen.device)
    return w.uniform_(-scale, scale, generator=gen).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(F32))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(F32) + bias.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, placed once (a copy
    from the host per call would wait for the card every layer)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=F32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)       # [hd/2]
    angles = positions.to(F32)[..., None] * freqs             # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _online_softmax_block(q, k, v, mask, m_prev, l_prev, acc_prev):
    """One flash-attention block update. q:[B,H,Tq,hd] k,v:[B,H,Tk,hd];
    scores and the accumulator in float32, the probabilities cast to v's
    dtype before the value product (as the reference)."""
    s = torch.matmul(q.to(F32), k.to(F32).transpose(-1, -2))
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc_new = acc_prev * alpha[..., None] + torch.matmul(
        p.to(v.dtype).to(F32), v.to(F32))
    return m_new, l_new, acc_new


def _as_column(kv_len: Length) -> Length:
    """A valid-prefix length as ``[B or 1, 1]`` (a tensor stays on its
    device; an int stays an int)."""
    return kv_len.reshape(-1, 1) if isinstance(kv_len, torch.Tensor) \
        else kv_len


def chunked_attention(
    q: torch.Tensor,            # [B, Sq, H, hd]
    k: torch.Tensor,            # [B, Skv, KV, hd]
    v: torch.Tensor,            # [B, Skv, KV, hd]
    *,
    causal: bool,
    q_offset: Length = 0,
    kv_len: Optional[Length] = None,   # valid KV prefix length (decode)
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA flash-style attention; returns [B, Sq, H, hd].

    KV heads are broadcast to Q heads by grouping. ``q_offset`` is the
    global position of q[0] (prefill continuation / decode); ``kv_len``
    masks the unwritten tail of a preallocated KV cache. Either may be a
    0-d tensor on the device.
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    groups = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    qh = (q.transpose(1, 2) * scale).to(q.dtype)              # [B,H,Sq,hd]
    kh = torch.repeat_interleave(k.transpose(1, 2), groups, dim=1)
    vh = torch.repeat_interleave(v.transpose(1, 2), groups, dim=1)

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    # odd lengths fall back to a single chunk
    if sq % q_chunk:
        q_chunk = sq
    if skv % kv_chunk:
        kv_chunk = skv
    nq, nk = sq // q_chunk, skv // kv_chunk
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qh[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=F32, device=dev)
        l_sum = torch.zeros((b, h, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((b, h, q_chunk, hdv), dtype=F32, device=dev)
        for ki in range(nk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if kv_len is not None:
                mask &= k_pos[None, :] < kv_len
            m, l_sum, acc = _online_softmax_block(
                qb, kh[:, :, sl], vh[:, :, sl], mask, m, l_sum, acc)
        out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    # [B, H, Sq, hdv] -> [B, Sq, H, hdv]
    return torch.cat(outs, dim=2).transpose(1, 2)


def decode_attention_append(
    q: torch.Tensor,            # [B, 1, H, hd]
    k_cache: torch.Tensor,      # [B, S, KV, hd]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,        # [B, 1, KV, hd] — current token's key
    v_new: torch.Tensor,
    kv_len: Length,             # [] — valid cache prefix length
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over (cache ∪ current token) without copying the
    cache: the self term is concatenated on the (tiny) score axis only."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    groups = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = (q[:, 0].to(F32) * scale).reshape(b, kv, groups, hd)
    s_cache = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(F32))
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < _as_column(kv_len)
    s_cache = torch.where(mask[:, None, None, :], s_cache, NEG_INF)
    s_self = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].to(F32))
    s_all = torch.cat([s_cache, s_self[..., None]], dim=-1)
    p = torch.softmax(s_all, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p[..., :-1], v_cache.to(F32))
    out = out + p[..., -1][..., None] * v_new[:, 0].to(F32)[:, :, None, :]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # [B, 1, H, hd]
    k_cache: torch.Tensor,      # [B, S, KV, hd]
    v_cache: torch.Tensor,
    kv_len: Length,             # [] or [B] — valid prefix length
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a preallocated KV cache."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    groups = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = (q[:, 0].to(F32) * scale).reshape(b, kv, groups, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(F32))
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < _as_column(kv_len)                 # [B or 1, S]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (params + apply)
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg) -> dict:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dt = cfg.torch_dtype
    p = {
        "wq": dense_init(gen, d, h * hd, dt),
        "wk": dense_init(gen, d, kv * hd, dt),
        "wv": dense_init(gen, d, kv * hd, dt),
        "wo": dense_init(gen, h * hd, d, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    return p


def gqa_qkv(params: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project + RoPE. Returns q [B,S,H,hd], k/v [B,S,KV,hd]."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kv, hd)
    v = (x @ params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(params: Params, cfg, x: torch.Tensor, positions, *,
               causal: bool = True, q_offset: Length = 0,
               kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               kv_len: Optional[Length] = None):
    """Full GQA block. With ``kv_cache=(k, v)`` and S == 1 runs the decode
    path. Returns (out [B,S,d], (k_new, v_new)) — new KV for the cache."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(params, cfg, x, positions)
    if kv_cache is not None:
        kc, vc = kv_cache
        if s != 1:
            raise ValueError("cache path expects single-token decode")
        out = decode_attention_append(q, kc, vc, k, v, kv_len)
    else:
        out = chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len, q_chunk=cfg.attn_chunk,
                                kv_chunk=cfg.attn_chunk)
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    return out.reshape(b, s, h * hd) @ params["wo"], (k, v)


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = cfg.torch_dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, dt),
        "wq_b": dense_init(gen, m.q_lora_rank, h * qk_head, dt),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dt),
        "wkv_b": dense_init(gen, m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim), dt),
        "wo": dense_init(gen, h * m.v_head_dim, d, dt),
        "q_a_norm": torch.zeros((m.q_lora_rank,), dtype=dt,
                                device=gen.device),
        "kv_a_norm": torch.zeros((m.kv_lora_rank,), dtype=dt,
                                 device=gen.device),
    }


def mla_attend(params: Params, cfg, x: torch.Tensor, positions, *,
               causal: bool = True, q_offset: Length = 0,
               kv_cache: Optional[torch.Tensor] = None,
               kv_len: Optional[Length] = None):
    """The MLA block. ``kv_cache`` ``[B, C, kv_lora + rope]`` (with S == 1)
    runs the absorbed decode over the cache's first ``kv_len`` rows and the
    token itself. Returns (out [B,S,d], cache_row [B, S, kv_lora + rope]):
    the compressed latent and the rope key, the row the cache stores."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    lora = m.kv_lora_rank

    q_lat = rmsnorm(x @ params["wq_a"], params["q_a_norm"], cfg.norm_eps)
    q = (q_lat @ params["wq_b"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ params["wkv_a"]                         # [B,S,kv_lora+rope]
    c_kv = rmsnorm(kv_a[..., :lora], params["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, lora:], positions,
                        cfg.rope_theta)                # [B,S,1,rope]
    cache_row = torch.cat([c_kv, k_rope[..., 0, :]], dim=-1)

    scale = 1.0 / math.sqrt(nope + rope_d)

    if kv_cache is not None:
        # absorbed decode: the scores contract q_nope, folded through the
        # key half of wkv_b, against the cached latents; the output latent
        # goes through the value half. q_lat stays in the activation
        # dtype, the scores are float32, out_lat is cast back.
        if s != 1:
            raise ValueError("cache path expects single-token decode")
        c_all, kr_all = kv_cache[..., :lora], kv_cache[..., lora:]
        wkv_b = params["wkv_b"].reshape(lora, h, nope + vd)
        wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wk_b)    # [B,1,H,lora]
        s_lat = torch.einsum("bshl,btl->bhst", q_lat.to(F32),
                             c_all.to(F32))
        s_rope = torch.einsum("bshr,btr->bhst", q_rope.to(F32),
                              kr_all.to(F32))
        s_cache = (s_lat + s_rope) * scale
        pos = torch.arange(c_all.shape[1], device=x.device)
        mask = pos[None, :] < _as_column(kv_len)
        s_cache = torch.where(mask[:, None, None, :], s_cache, NEG_INF)
        # the self term from the token's own cache row
        c_new, kr_new = cache_row[..., :lora], cache_row[..., lora:]
        s_self = (torch.einsum("bshl,bsl->bhs", q_lat.to(F32),
                               c_new.to(F32))
                  + torch.einsum("bshr,bsr->bhs", q_rope.to(F32),
                                 kr_new.to(F32))) * scale
        p = torch.softmax(torch.cat([s_cache, s_self[..., None]], dim=-1),
                          dim=-1)
        out_lat = torch.einsum("bhst,btl->bshl", p[..., :-1], c_all.to(F32))
        out_lat = out_lat + p[..., -1].transpose(1, 2)[..., None] \
            * c_new.to(F32)[:, :, None, :]
        out = torch.einsum("bshl,lhv->bshv", out_lat.to(x.dtype), wv_b)
    else:
        kv = (c_kv @ params["wkv_b"]).reshape(b, s, h, nope + vd)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qfull, k, v, causal=causal,
                                q_offset=q_offset, kv_len=kv_len,
                                q_chunk=cfg.attn_chunk,
                                kv_chunk=cfg.attn_chunk, scale=scale)
    return out.reshape(b, s, h * vd) @ params["wo"], cache_row


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "gate": dense_init(gen, d, d_ff, dtype),
        "up": dense_init(gen, d, d_ff, dtype),
        "down": dense_init(gen, d_ff, d, dtype),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["gate"]) * (x @ params["up"])) @ params["down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

VOCAB_PAD = 256     # table rows pad to this multiple (axis divisibility)


def pad_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    """[pad_vocab(V), d] table; rows >= V are never gathered and their
    logits are masked in :func:`unembed`."""
    t = torch.empty((pad_vocab(vocab), d), dtype=F32, device=gen.device)
    return (t.normal_(generator=gen) * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor,
            n_valid: Optional[int] = None) -> torch.Tensor:
    """float32 logits against a (possibly tied, vocab-padded) [V_pad, d]
    table. ``n_valid`` masks the padding rows to ``NEG_INF`` so softmax
    and argmax see exactly the true vocabulary."""
    logits = torch.einsum("bsd,vd->bsv", x.to(F32), table.to(F32))
    if n_valid is not None and n_valid < table.shape[0]:
        logits[..., n_valid:] = NEG_INF
    return logits
