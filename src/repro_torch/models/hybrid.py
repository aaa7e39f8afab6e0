"""Zamba2-style hybrid LM: a deep Mamba2 trunk with one weight-*shared*
attention block applied after every ``shared_attn_every``-th Mamba layer —
the port of ``repro/models/hybrid.py``.

zamba2-7b: 81 Mamba2 layers (d_state 64) and one shared GQA attention +
SwiGLU MLP block (d_ff 14,336) applied after layers 6, 12, ..., 78: 13
invocations of the same weights, then a tail of 3 Mamba layers with no
shared block after it. The reference groups the trunk into scans of
``every`` layers (``n_groups = n_layers // every`` groups and the tail);
the port loops over the layers in the same order.

``Zamba2Model`` is an ``nn.Module`` whose parameter paths are the
reference's tree: ``embed``, ``mamba_layers.{i}.norm`` and
``mamba_layers.{i}.mix.*`` (Mamba2's ``in_proj``, ``conv_w``, ``a_log``,
``dt_bias``, ``d_skip`` (these three float32 in any model dtype),
``norm``, ``out_proj``; the reference stacks them ``[L, ...]``,
``convert.model_params_from_reference`` unstacks them), ``shared.ln1``,
``shared.attn.{wq,wk,wv,wo}``, ``shared.ln2``,
``shared.mlp.{gate,up,down}`` (one copy), ``final_norm`` and
``unembed`` (not tied).

Entry points, as ``TransformerLM``'s: ``init_params(generator)``,
``forward``, ``loss``, ``prefill``, ``init_cache`` and ``decode``.
``forward``, ``prefill`` and ``decode`` also take ``embeds=`` ``[B, S,
d]`` in place of ``tokens`` (the private-embedding twin);
``prefix_embeds=`` is accepted and ignored, as the reference's.

The cache (:class:`HybridCache`) holds the decode state of both halves:
every Mamba layer's conv tail and SSD state, which do not grow with the
length, and one KV cache per shared-block invocation (the weights are
shared, the activations are not), which does. ``prefill(capacity=)``
extends the reference as ``TransformerLM``'s does: the KV caches get C >=
S rows (the rows past S zero), so that ``decode(write=True)`` has room to
append; without it they hold exactly S rows, as the reference's.
``decode(write=True)`` writes each invocation's new K / V row at the
device length, in place (a write past the capacity lands on the last
row, as ``dynamic_update_slice`` clamps); ``write=False`` attends over
cache ∪ self and leaves the given KV caches untouched. Both return new
Mamba states (the given ones are never written) and advance the length.

``forward``, ``prefill`` and ``decode`` run without autograd; ``loss``
records it. With ``remat="block"`` each Mamba layer of a pass that
records autograd is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference wraps its scanned layer
body in ``jax.checkpoint``; the shared block is not, as in the reference.
Prompts must be at most ``cfg.ssm.chunk`` tokens or a multiple of it
(``ssd_scan`` raises otherwise, as the reference's).

Not ported: ``param_specs`` and ``cache_specs`` (mesh layout).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import _weight, _xent

F32 = torch.float32


class HybridCache(NamedTuple):
    """The hybrid's decode state. ``conv`` [L, B, K-1, d_inner + 2N] in
    the model dtype and ``state`` [L, B, H, P, N] float32, a Mamba layer
    each; ``attn_k`` / ``attn_v`` [n_groups, B, C, KV, hd], a shared-block
    invocation each; ``length`` a 0-d int32 tensor on the device."""
    conv: torch.Tensor
    state: torch.Tensor
    attn_k: torch.Tensor
    attn_v: torch.Tensor
    length: torch.Tensor

    def nbytes(self) -> int:
        """Bytes of the decode state (every field but ``length``)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.conv, self.state, self.attn_k, self.attn_v))


class MambaLayer(nn.Module):
    """One pre-norm residual Mamba2 layer: ``norm`` [d] and the mixer
    ``mix``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm = _weight(cfg.d_model, dtype=cfg.torch_dtype,
                            device=device)
        self.mix = nn.ParameterDict({
            name: _weight(*shape, dtype=dt, device=device)
            for name, (shape, dt) in S.mamba2_shapes(cfg).items()})

    @torch.no_grad()
    def init_params(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.norm.zero_()
        for name, value in S.mamba2_init(gen, cfg).items():
            self.mix[name].copy_(value)


class SharedBlock(nn.Module):
    """The weight-shared block: ``ln1``, GQA ``attn``, ``ln2`` and the
    SwiGLU ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd, dt = cfg.resolved_head_dim, cfg.torch_dtype
        w = lambda *shape: _weight(*shape, dtype=dt, device=device)
        self.ln1 = w(d)
        self.ln2 = w(d)
        attn = {"wq": w(d, h * hd), "wk": w(d, kv * hd),
                "wv": w(d, kv * hd), "wo": w(h * hd, d)}
        if cfg.qk_norm:
            attn.update(q_norm=w(hd), k_norm=w(hd))
        self.attn = nn.ParameterDict(attn)
        self.mlp = nn.ParameterDict({"gate": w(d, cfg.d_ff),
                                     "up": w(d, cfg.d_ff),
                                     "down": w(cfg.d_ff, d)})

    @torch.no_grad()
    def init_params(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        for k, v in L.gqa_init(gen, cfg).items():
            self.attn[k].copy_(v)
        for k, v in L.mlp_init(gen, cfg.d_model, cfg.d_ff,
                               cfg.torch_dtype).items():
            self.mlp[k].copy_(v)


class Zamba2Model(nn.Module):
    """The hybrid LM on one device (``device=None`` is the current default
    device; ``registry.build_model`` resolves it)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 remat: str = "block"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat {remat!r}; expected 'none' or "
                             "'block'")
        if cfg.family != "hybrid" or cfg.ssm is None:
            raise ValueError(f"{cfg.name!r}: Zamba2Model takes a hybrid "
                             "config with ssm=")
        self.cfg = cfg
        self.remat = remat
        self.every = cfg.ssm.shared_attn_every or 6
        self.n_groups = cfg.n_layers // self.every
        self.tail = cfg.n_layers - self.n_groups * self.every
        dt = cfg.torch_dtype
        v_pad = L.pad_vocab(cfg.vocab)
        self.embed = _weight(v_pad, cfg.d_model, dtype=dt, device=device)
        self.mamba_layers = nn.ModuleList(MambaLayer(cfg, device)
                                          for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device)
        self.final_norm = _weight(cfg.d_model, dtype=dt, device=device)
        self.unembed = _weight(v_pad, cfg.d_model, dtype=dt, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "Zamba2Model":
        """Draw every weight from ``gen`` (on the module's device): the
        tables normal(0, 0.02), the matrices uniform(±1/sqrt(d_in)),
        ``conv_w`` normal x 0.1, Mamba2's ``a_log`` 0, ``dt_bias`` log(e -
        1) and ``d_skip`` 1 (float32), the norm scales 0 (``1 + scale`` is
        applied). Returns the module."""
        cfg = self.cfg
        self.embed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                      cfg.torch_dtype))
        for layer in self.mamba_layers:
            layer.init_params(gen, cfg)
        self.shared.init_params(gen, cfg)
        self.final_norm.zero_()
        self.unembed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                        cfg.torch_dtype))
        return self

    # -- pieces ---------------------------------------------------------------

    def _mamba(self, layer: MambaLayer, x, cache=None):
        h = L.rmsnorm(x, layer.norm, self.cfg.norm_eps)
        y, new_cache = S.mamba2_apply(layer.mix, self.cfg, h, cache=cache)
        return x + y, new_cache

    def _shared_block(self, x, positions, kv_cache=None, kv_len=None):
        sp, cfg = self.shared, self.cfg
        h = L.rmsnorm(x, sp.ln1, cfg.norm_eps)
        a, kv = L.gqa_attend(sp.attn, cfg, h, positions, kv_cache=kv_cache,
                             kv_len=kv_len)
        x = x + a
        h = L.rmsnorm(x, sp.ln2, cfg.norm_eps)
        return x + L.mlp_apply(sp.mlp, h), kv

    def _run(self, x, *, cache: Optional[HybridCache] = None,
             want_cache: bool = False):
        """The trunk over ``x`` [B, S, d]: each Mamba layer, and the shared
        block after every ``every``-th (not after the tail). With a
        ``cache`` (S == 1) each Mamba layer steps from its state and each
        invocation attends over its own KV cache at the cache's length.
        Returns (the final-normed x, the Mamba layers' (conv, state), the
        invocations' (k, v) rows), the lists empty unless ``want_cache``
        or a cache is given."""
        cfg = self.cfg
        if cache is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        else:
            positions = cache.length.reshape(1, 1)
        keep = want_cache or cache is not None
        remat = (self.remat == "block" and torch.is_grad_enabled()
                 and not keep)
        mamba, rows = [], []
        for i, layer in enumerate(self.mamba_layers):
            if remat:
                x = checkpoint(lambda h, m=layer: self._mamba(m, h)[0], x,
                               use_reentrant=False)
            else:
                lc = (None if cache is None
                      else (cache.conv[i], cache.state[i]))
                x, c = self._mamba(layer, x, cache=lc)
                if keep:
                    mamba.append(c)
            if (i + 1) % self.every == 0:              # shared block
                g = (i + 1) // self.every - 1
                kvc = (None if cache is None
                       else (cache.attn_k[g], cache.attn_v[g]))
                x, kv = self._shared_block(
                    x, positions, kv_cache=kvc,
                    kv_len=None if cache is None else cache.length)
                if keep:
                    rows.append(kv)
        return L.rmsnorm(x, self.final_norm, cfg.norm_eps), mamba, rows

    def _embed(self, tokens, embeds):
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens= and embeds=")
        return (embeds.to(self.cfg.torch_dtype) if embeds is not None
                else L.embed_lookup(self.embed, tokens))

    def _logits(self, x) -> torch.Tensor:
        return L.unembed(x, self.unembed, self.cfg.vocab)

    # -- public entry points --------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens=None, *, embeds=None, prefix_embeds=None):
        """Full-sequence pass. Returns (logits [B, S, V_pad] f32, a zero
        aux). ``prefix_embeds`` is ignored, as the reference's."""
        del prefix_embeds
        return self._forward(tokens, embeds)

    def _forward(self, tokens, embeds):
        x, _, _ = self._run(self._embed(tokens, embeds))
        return self._logits(x), torch.zeros((), dtype=F32, device=x.device)

    def loss(self, tokens, **_):
        """Next-token cross-entropy in float32 over ``tokens`` [B, S] (the
        reference's ``_xent(logits[:, :-1], tokens[:, 1:])``), recorded for
        autograd where grad is enabled. Returns (loss, {})."""
        tokens = tokens.long()
        logits, _ = self._forward(tokens, None)
        return _xent(logits[:, :-1], tokens[:, 1:]), {}

    @torch.no_grad()
    def prefill(self, tokens=None, *, embeds=None, prefix_embeds=None,
                capacity: Optional[int] = None):
        """Pass over the prompt: last-position logits [B, V_pad] and the
        cache (KV caches of ``capacity`` rows, default the prompt length).
        ``prefix_embeds`` is ignored."""
        del prefix_embeds
        x = self._embed(tokens, embeds)
        b, s = x.shape[:2]
        cap = s if capacity is None else capacity
        if cap < s:
            raise ValueError(f"capacity {cap} < sequence length {s}")
        x, mamba, rows = self._run(x, want_cache=True)
        logits = self._logits(x[:, -1:])[:, 0]
        cache = self.init_cache(b, cap)
        for i, (conv, state) in enumerate(mamba):
            cache.conv[i] = conv
            cache.state[i] = state
        for g, (k, v) in enumerate(rows):
            cache.attn_k[g, :, :s] = k
            cache.attn_v[g, :, :s] = v
        return logits, cache._replace(length=cache.length + s)

    @torch.no_grad()
    def decode(self, cache: HybridCache, tokens=None, *, embeds=None,
               write: bool = True):
        """One decode step, tokens [B, 1]. Returns (logits [B, V_pad], the
        cache with new Mamba states and the length + 1). ``write=True``
        appends each invocation's K / V row at ``cache.length`` in place;
        ``write=False`` leaves the KV caches as they are."""
        x = self._embed(tokens, embeds)
        x, mamba, rows = self._run(x, cache=cache)
        logits = self._logits(x)[:, 0]
        conv = torch.stack([c for c, _ in mamba])
        state = torch.stack([s for _, s in mamba])
        if write and rows:
            # the row index stays on the device; clamped to the last row,
            # as dynamic_update_slice clamps its start
            pos = torch.clamp(cache.length, max=cache.attn_k.shape[2] - 1)
            pos = pos.reshape(1).to(torch.int64)
            ks = torch.stack([k for k, _ in rows])     # [G, B, 1, KV, hd]
            vs = torch.stack([v for _, v in rows])
            cache.attn_k.index_copy_(2, pos, ks.to(cache.attn_k.dtype))
            cache.attn_v.index_copy_(2, pos, vs.to(cache.attn_v.dtype))
        return logits, cache._replace(conv=conv, state=state,
                                      length=cache.length + 1)

    def init_cache(self, batch: int, capacity: int) -> HybridCache:
        """A zero cache for ``batch`` streams: the Mamba states (whose size
        does not depend on ``capacity``) and ``n_groups`` KV caches of
        ``capacity`` rows."""
        cfg = self.cfg
        conv, state = S.mamba2_cache_init(cfg, batch, device=self.device)
        kv = (self.n_groups, batch, capacity, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        z = lambda: torch.zeros(kv, dtype=cfg.torch_dtype,
                                device=self.device)
        return HybridCache(conv=conv.new_zeros((cfg.n_layers,) + conv.shape),
                           state=state.new_zeros((cfg.n_layers,)
                                                 + state.shape),
                           attn_k=z(), attn_v=z(),
                           length=torch.zeros((), dtype=torch.int32,
                                              device=self.device))
