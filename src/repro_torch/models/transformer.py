"""Decoder-only transformer LM, dense family — the port of
``repro/models/transformer.py``.

``TransformerLM`` is an ``nn.Module``: the token table, an
``nn.ModuleList`` of :class:`Block` layers, the final norm and the
(untied) unembedding table, every weight in the reference's ``x @ W``
orientation. Where the reference scans layer parameters stacked on a
leading ``[L, ...]`` axis, the port loops over the blocks;
``convert.model_params_from_reference`` unstacks the reference's tree into
this module's state.

Entry points (as the reference's, with the weights held by the module):
  init_params(generator)         draw the weights (an explicit generator)
  forward(tokens)                full-sequence causal logits
  loss(tokens)                   next-token cross-entropy, grad enabled
  prefill(tokens)                last-position logits + the filled cache
  init_cache(batch, capacity)    a preallocated, empty cache
  decode(cache, tokens)          one token against the cache
``forward``, ``prefill`` and ``decode`` also take ``embeds=`` (``[B, S,
d]``) in place of ``tokens``: a pass that starts from client-side
embeddings (the private embedding lookup), as
``examples/private_inference.py`` runs the reference's layer stack.

``forward``, ``prefill`` and ``decode`` run without autograd; ``loss``
records it. Parameters are created with ``requires_grad=False``: the train
step (``runtime/steps.make_train_step``) turns it on for its own model.
With ``remat="block"`` (the reference's default) a pass that records
autograd keeps only each block's input and recomputes the block in the
backward pass (``torch.utils.checkpoint``), as the reference wraps its
scanned layer body in ``jax.checkpoint``; ``remat="none"`` keeps every
activation.

The KV cache is ``[L, B, C, KV, hd]`` for k and v with ``length`` a 0-d
int32 tensor on the device, read there (positions, masks, the write row)
so that a decode step never waits for the card. ``prefill(capacity=)``
extends the reference: it allocates C >= S rows (the rows past S zero), so
that ``decode(write=True)`` has room to append; without it the cache holds
exactly S rows, as the reference's. Like ``jax.lax.dynamic_update_slice``,
a write past the capacity lands on the last row.

``decode`` updates the cache's tensors in place (the reference donates the
cache to its decode step) and returns a cache with the new length.

Not ported yet: ``_mtp_loss`` (only deepseek-v3 sets ``mtp``; it comes
with the MoE family), MoE layers, MLA, ``prefix_embeds`` (VLM) and the
``*_specs`` (mesh layout).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import AttentionKind, ModelConfig
from repro_torch.models import layers as L

F32 = torch.float32


class KVCache(NamedTuple):
    """Preallocated decode cache: k / v [Layers, B, C, KV, hd]."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor    # [] int32 — valid prefix, on the cache's device


def _weight(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One pre-norm layer: GQA attention and the SwiGLU MLP (the
    reference's ``_layer_init`` / ``_layer`` with ``moe_layer=False``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd, dt = cfg.resolved_head_dim, cfg.torch_dtype
        w = lambda *shape: _weight(*shape, dtype=dt, device=device)
        self.ln1 = w(d)
        self.ln2 = w(d)
        attn = {"wq": w(d, h * hd), "wk": w(d, kv * hd), "wv": w(d, kv * hd),
                "wo": w(h * hd, d)}
        if cfg.qk_norm:
            attn.update(q_norm=w(hd), k_norm=w(hd))
        self.attn = nn.ParameterDict(attn)
        self.ffn = nn.ParameterDict(
            {"gate": w(d, cfg.d_ff), "up": w(d, cfg.d_ff),
             "down": w(cfg.d_ff, d)})

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        self.ln1.zero_()
        self.ln2.zero_()
        for k, v in L.gqa_init(gen, cfg).items():
            self.attn[k].copy_(v)
        for k, v in L.mlp_init(gen, cfg.d_model, cfg.d_ff,
                               cfg.torch_dtype).items():
            self.ffn[k].copy_(v)

    def forward(self, x, positions, *, kv_cache=None, kv_len=None):
        """Returns (x', (k_new, v_new))."""
        cfg = self.cfg
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        attn_out, kv_new = L.gqa_attend(self.attn, cfg, h, positions,
                                        kv_cache=kv_cache, kv_len=kv_len)
        x = x + attn_out
        h = L.rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + L.mlp_apply(self.ffn, h), kv_new


class TransformerLM(nn.Module):
    """The dense decoder-only LM on one device (``device=None`` is the
    current default device; ``registry.build_model`` resolves it)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 remat: str = "block"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat {remat!r}; expected 'none' or "
                             "'block'")
        self.remat = remat
        if cfg.family != "dense" or cfg.attention != AttentionKind.GQA:
            raise NotImplementedError(
                f"TransformerLM serves the dense GQA family; {cfg.name!r} is "
                f"{cfg.family!r} / {cfg.attention.value!r}, not ported yet")
        if cfg.mtp:
            raise NotImplementedError("the MTP head comes with the MoE family")
        self.cfg = cfg
        dt = cfg.torch_dtype
        v_pad = L.pad_vocab(cfg.vocab)
        self.embed = _weight(v_pad, cfg.d_model, dtype=dt, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _weight(cfg.d_model, dtype=dt, device=device)
        self.unembed = (None if cfg.tie_embeddings else
                        _weight(v_pad, cfg.d_model, dtype=dt, device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters ---------------------------------------------------------

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "TransformerLM":
        """Draw every weight from ``gen`` (on the module's device): the
        tables normal(0, 0.02), the matrices uniform(±1/sqrt(d_in)), the
        norm scales 0 (``1 + scale`` is applied). Returns the module."""
        cfg = self.cfg
        self.embed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                      cfg.torch_dtype))
        for block in self.layers:
            block.init_params(gen)
        self.final_norm.zero_()
        if self.unembed is not None:
            self.unembed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                            cfg.torch_dtype))
        return self

    # -- layer stack ----------------------------------------------------------

    def _scan_stack(self, x, positions, *, cache: Optional[KVCache] = None,
                    kv_len=None, want_cache: bool = True
                    ) -> Tuple[torch.Tensor, List[tuple]]:
        """Run the blocks in order. Returns (x, per-layer (k, v) rows,
        empty when ``want_cache`` is False)."""
        rows = []
        remat = self.remat == "block" and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            if remat and cache is None and not want_cache:
                x = checkpoint(lambda h, b=block: b(h, positions)[0], x,
                               use_reentrant=False)
                continue
            layer_cache = None if cache is None else (cache.k[i], cache.v[i])
            x, kv_new = block(x, positions, kv_cache=layer_cache,
                              kv_len=kv_len)
            if want_cache:
                rows.append(kv_new)
        return x, rows

    # -- embeddings -----------------------------------------------------------

    def _embed(self, tokens, embeds):
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens= and embeds=")
        if embeds is not None:
            return embeds.to(self.cfg.torch_dtype)
        return L.embed_lookup(self.embed, tokens)

    def _unembed_table(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed

    def _logits(self, x) -> torch.Tensor:
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return L.unembed(x, self._unembed_table(), self.cfg.vocab)

    # -- public entry points --------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens=None, *, embeds=None):
        """Full-sequence causal pass. Returns (logits [B,S,V_pad] f32, aux);
        aux is the reference's auxiliary loss, 0 for the dense family."""
        return self._forward(tokens, embeds)

    def _forward(self, tokens, embeds):
        x = self._embed(tokens, embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = self._scan_stack(x, positions, want_cache=False)
        return self._logits(x), torch.zeros((), dtype=F32, device=x.device)

    def loss(self, tokens, *, aux_weight: float = 0.01):
        """Next-token cross-entropy in float32 over ``tokens`` [B, S] (+
        ``aux_weight`` x the auxiliary loss, 0 here), recorded for autograd
        where grad is enabled. Returns (total, {"ce", "aux"})."""
        tokens = tokens.long()
        logits, aux = self._forward(tokens, None)
        ce = _xent(logits[:, :-1], tokens[:, 1:])
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, tokens=None, *, embeds=None,
                capacity: Optional[int] = None):
        """Causal pass returning last-position logits [B, V_pad] and the
        filled cache (``capacity`` rows, default the sequence length)."""
        x = self._embed(tokens, embeds)
        b, s = x.shape[:2]
        cap = s if capacity is None else capacity
        if cap < s:
            raise ValueError(f"capacity {cap} < sequence length {s}")
        positions = torch.arange(s, device=x.device)[None, :]
        x, rows = self._scan_stack(x, positions)
        logits = self._logits(x[:, -1:])[:, 0]
        cache = self.init_cache(b, cap)
        for i, (k, v) in enumerate(rows):
            cache.k[i, :, :s] = k
            cache.v[i, :, :s] = v
        return logits, cache._replace(length=cache.length + s)

    def init_cache(self, batch: int, capacity: int) -> KVCache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        z = lambda: torch.zeros(shape, dtype=cfg.torch_dtype,
                                device=self.device)
        return KVCache(k=z(), v=z(),
                       length=torch.zeros((), dtype=torch.int32,
                                          device=self.device))

    @torch.no_grad()
    def decode(self, cache: KVCache, tokens=None, *, embeds=None,
               write: bool = True):
        """One decode step. tokens [B, 1]. Returns (logits [B,V_pad],
        cache').

        ``write=True`` appends the new KV rows at ``cache.length`` (in
        place); ``write=False`` attends over cache ∪ self via the
        score-append path and writes nothing. Both advance the length.
        """
        x = self._embed(tokens, embeds)
        positions = cache.length.reshape(1, 1)
        x, rows = self._scan_stack(x, positions, cache=cache,
                                   kv_len=cache.length, want_cache=write)
        logits = self._logits(x)[:, 0]
        if write:
            return logits, self._write_rows(cache, rows)
        return logits, cache._replace(length=cache.length + 1)

    def _write_rows(self, cache: KVCache, rows) -> KVCache:
        # the row index stays on the device; clamped to the last row, as
        # dynamic_update_slice clamps its start
        pos = torch.clamp(cache.length, max=cache.k.shape[2] - 1).reshape(1)
        ks = torch.stack([k for k, _ in rows])          # [L, B, 1, KV, hd]
        vs = torch.stack([v for _, v in rows])
        cache.k.index_copy_(2, pos.to(torch.int64), ks.to(cache.k.dtype))
        cache.v.index_copy_(2, pos.to(torch.int64), vs.to(cache.v.dtype))
        return cache._replace(length=cache.length + 1)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32. logits [B, S, V], targets [B, S]."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - picked)
