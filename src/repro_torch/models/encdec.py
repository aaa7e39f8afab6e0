"""Whisper-style encoder-decoder transformer (the audio family) — the port
of ``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the client hands
over precomputed frame embeddings ``frame_embeds`` ``[B, encoder_len,
d]``; the encoder adds sinusoidal positions and runs non-causal
self-attention over them. The decoder adds learned positions
(``pos_dec``, ``[32768, d]``), runs causal self-attention and, in every
layer, cross-attention over the encoder's output, whose K/V are computed
once per sequence and cached. Pre-LayerNorm, GELU two-matrix MLPs, no
attention biases, MHA as the KV == heads case of the GQA path, the token
table tied as the unembedding: the reference's choices.

``EncDecLM`` is an ``nn.Module`` whose parameter paths are the reference's
tree: ``embed``, ``pos_dec``, ``enc_layers.{i}.{ln1,attn,ln2,mlp}``,
``dec_layers.{i}.{ln1,self_attn,ln2,cross_attn,ln3,mlp}``, ``enc_norm``
and ``dec_norm`` (each norm a ``scale`` and a ``bias``, each MLP ``fc1``
and ``fc2``). Where the reference scans layers stacked on a leading
``[L, ...]`` axis, the port loops over them;
``convert.model_params_from_reference`` unstacks the reference's tree.

Entry points, as ``TransformerLM``'s: ``init_params(generator)``,
``encode``, ``forward``, ``loss``, ``prefill(capacity=)``,
``init_cache`` and ``decode(write=)``. Each pass over the encoder takes
``frame_embeds=`` (``prefix_embeds=`` is its alias, as in the reference).
``forward``, ``prefill`` and ``decode`` also take ``embeds=`` ``[B, S,
d]`` in place of ``tokens`` (the private-embedding twin); the learned
decoder positions are added to given embeddings as to looked-up rows.

Stated deviations:
* the frames are cast to the model's dtype on entry, as ``input_specs``
  declares them (the reference, handed float32 frames, would run its
  encoder's residual stream in float32 by type promotion);
* ``prefill`` computes each layer's cross K/V once and hands them to the
  layer and to the cache (the reference computes them twice, with the same
  values);
* ``forward``, ``prefill`` and ``decode`` run without autograd, ``loss``
  records it; with ``remat="block"`` each encoder and decoder layer of a
  pass that records autograd is recomputed in the backward pass
  (``torch.utils.checkpoint``), as the reference wraps its scanned layer
  bodies in ``jax.checkpoint``.

The cache (:class:`EncDecCache`): the decoder's self-attention rows
``self_k`` / ``self_v`` ``[L, B, C, KV, hd]``, the cross-attention K/V
``cross_k`` / ``cross_v`` ``[L, B, T_enc, H, hd]`` and ``length``, a 0-d
int32 tensor on the device, read there (the decoder position, the masks,
the write row) so that a decode step never waits for the host.
``decode(write=True)`` writes the new rows in place; a write past the
capacity lands on the last row, as ``dynamic_update_slice`` clamps, and
the decoder position at ``length`` is clamped into ``pos_dec`` as
``dynamic_slice_in_dim`` clamps.

Not ported: ``param_specs`` and ``cache_specs`` (mesh layout; ROADMAP
A6b).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _weight, _xent

F32 = torch.float32


class EncDecCache(NamedTuple):
    self_k: torch.Tensor      # [L, B, C, KV, hd]
    self_v: torch.Tensor
    cross_k: torch.Tensor     # [L, B, T_enc, H, hd]
    cross_v: torch.Tensor
    length: torch.Tensor      # [] int32 — valid prefix, on the device


def sinusoid_positions(n: int, d: int) -> np.ndarray:
    """The encoder's positions ``[n, d]`` in numpy float64, as the
    reference computes them (sines, then cosines)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)


@functools.lru_cache(maxsize=8)
def _positions_on(n: int, d: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """:func:`sinusoid_positions` cast from float64 to ``dtype`` on the
    host (the reference's one rounding) and placed once on ``device``."""
    return torch.from_numpy(sinusoid_positions(n, d)).to(dtype).to(device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _divisor_chunk(n: int, target: int = 768) -> int:
    """Largest divisor of n that is <= target (the attention chunk over
    the encoder's rows)."""
    best = 1
    for c in range(1, min(n, target) + 1):
        if n % c == 0:
            best = c
    return best


def _norm(d: int, dt, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _weight(d, dtype=dt, device=device),
                             "bias": _weight(d, dtype=dt, device=device)})


def _layernorm(x, p, eps):
    return L.layernorm(x, p["scale"], p["bias"], eps)


def _mlp(p, x):
    return gelu(x @ p["fc1"]) @ p["fc2"]


class _Layer(nn.Module):
    """The parameters both stacks' layers share: norms, attention weights
    and the GELU MLP, drawn as the reference draws them."""

    def __init__(self, cfg: ModelConfig, device, norms, attns):
        super().__init__()
        self.cfg = cfg
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, cfg.torch_dtype
        h, kv = cfg.n_heads, cfg.n_kv_heads
        w = lambda *shape: _weight(*shape, dtype=dt, device=device)
        for name in norms:
            setattr(self, name, _norm(d, dt, device))
        for name, n_kv in attns:
            setattr(self, name, nn.ParameterDict(
                {"wq": w(d, h * hd), "wk": w(d, n_kv * hd),
                 "wv": w(d, n_kv * hd), "wo": w(h * hd, d)}))
        self.mlp = nn.ParameterDict({"fc1": w(d, cfg.d_ff),
                                     "fc2": w(cfg.d_ff, d)})
        self._norms, self._attns = norms, [a for a, _ in attns]

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Norm scales 1 and biases 0; every matrix uniform(±1/sqrt(d_in))
        (``layers.dense_init``)."""
        for name in self._norms:
            getattr(self, name)["scale"].fill_(1)
            getattr(self, name)["bias"].zero_()
        for name in self._attns + ["mlp"]:
            for p in getattr(self, name).values():
                p.copy_(L.dense_init(gen, p.shape[0], p.shape[1], p.dtype))


class EncoderLayer(_Layer):
    """``ln1``, ``attn`` (non-causal MHA), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device, ("ln1", "ln2"),
                         (("attn", cfg.n_kv_heads),))

    def forward(self, x, positions, chunk: int):
        cfg = self.cfg
        b, s, _ = x.shape
        h = _layernorm(x, self.ln1, cfg.norm_eps)
        q, k, v = L.gqa_qkv(self.attn, cfg, h, positions)
        a = L.chunked_attention(q, k, v, causal=False, q_chunk=chunk,
                                kv_chunk=chunk)
        x = x + a.reshape(b, s, -1) @ self.attn["wo"]
        h = _layernorm(x, self.ln2, cfg.norm_eps)
        return x + _mlp(self.mlp, h)


class DecoderLayer(_Layer):
    """``ln1``, ``self_attn`` (causal), ``ln2``, ``cross_attn`` (over the
    encoder's states), ``ln3``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device, ("ln1", "ln2", "ln3"),
                         (("self_attn", cfg.n_kv_heads),
                          ("cross_attn", cfg.n_heads)))

    def cross_kv(self, enc: torch.Tensor):
        """The cross-attention K / V ``[B, T_enc, H, hd]`` of the encoder
        states ``enc``."""
        b, t, _ = enc.shape
        h, hd = self.cfg.n_heads, self.cfg.resolved_head_dim
        return ((enc @ self.cross_attn["wk"]).reshape(b, t, h, hd),
                (enc @ self.cross_attn["wv"]).reshape(b, t, h, hd))

    def forward(self, x, positions, *, enc=None, cross_kv=None,
                self_cache=None, kv_len=None):
        """Returns (x', (k, v)): the self-attention rows the cache keeps.
        The cross K/V come from ``cross_kv`` or are computed from
        ``enc``; with ``self_cache`` (S == 1) the self-attention runs the
        decode path over the cache's first ``kv_len`` rows and the token."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = _layernorm(x, self.ln1, cfg.norm_eps)
        q, k, v = L.gqa_qkv(self.self_attn, cfg, h, positions)
        if self_cache is not None:
            a = L.decode_attention_append(q, self_cache[0], self_cache[1],
                                          k, v, kv_len)
        else:
            c = min(cfg.attn_chunk, s)
            a = L.chunked_attention(q, k, v, causal=True, q_chunk=c,
                                    kv_chunk=c)
        x = x + a.reshape(b, s, -1) @ self.self_attn["wo"]
        h = _layernorm(x, self.ln2, cfg.norm_eps)
        qx = (h @ self.cross_attn["wq"]).reshape(b, s, cfg.n_heads,
                                                 cfg.resolved_head_dim)
        kx, vx = cross_kv if cross_kv is not None else self.cross_kv(enc)
        t_enc = kx.shape[1]
        if s == 1:
            a = L.decode_attention(qx, kx, vx, t_enc)
        else:
            a = L.chunked_attention(qx, kx, vx, causal=False,
                                    q_chunk=min(cfg.attn_chunk, s),
                                    kv_chunk=_divisor_chunk(t_enc))
        x = x + a.reshape(b, s, -1) @ self.cross_attn["wo"]
        h = _layernorm(x, self.ln3, cfg.norm_eps)
        return x + _mlp(self.mlp, h), (k, v)


class EncDecLM(nn.Module):
    """The whisper-shaped encoder-decoder on one device (``device=None``
    is the current default device; ``registry.build_model`` resolves
    it)."""

    MAX_DEC_POS = 32768

    def __init__(self, cfg: ModelConfig, *, device=None,
                 remat: str = "block"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat {remat!r}; expected 'none' or "
                             "'block'")
        if cfg.family != "audio" or not cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name!r}: EncDecLM takes an audio "
                             "config with n_encoder_layers > 0")
        self.cfg = cfg
        self.remat = remat
        dt = cfg.torch_dtype
        self.embed = _weight(L.pad_vocab(cfg.vocab), cfg.d_model, dtype=dt,
                             device=device)
        self.pos_dec = _weight(self.MAX_DEC_POS, cfg.d_model, dtype=dt,
                               device=device)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.enc_norm = _norm(cfg.d_model, dt, device)
        self.dec_norm = _norm(cfg.d_model, dt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "EncDecLM":
        """Draw every weight from ``gen`` (on the module's device): the
        token table normal(0, 0.02), the decoder positions normal(0,
        0.01), the matrices uniform(±1/sqrt(d_in)), the norms scale 1 and
        bias 0. Returns the module."""
        cfg = self.cfg
        self.embed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                      cfg.torch_dtype))
        pos = torch.empty(self.pos_dec.shape, dtype=F32, device=gen.device)
        self.pos_dec.copy_(pos.normal_(generator=gen) * 0.01)
        for layer in list(self.enc_layers) + list(self.dec_layers):
            layer.init_params(gen)
        for norm in (self.enc_norm, self.dec_norm):
            norm["scale"].fill_(1)
            norm["bias"].zero_()
        return self

    # -- the encoder ------------------------------------------------------------

    def _remat(self) -> bool:
        return self.remat == "block" and torch.is_grad_enabled()

    def encode(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """``frame_embeds`` ``[B, T_enc, d]`` (cast to the model's dtype)
        -> the encoder's states ``[B, T_enc, d]``."""
        cfg = self.cfg
        x = frame_embeds.to(cfg.torch_dtype)
        t_enc = x.shape[1]
        x = x + _positions_on(t_enc, cfg.d_model, x.dtype, x.device)[None]
        positions = torch.arange(t_enc, device=x.device)[None, :]
        chunk = _divisor_chunk(t_enc)
        for layer in self.enc_layers:
            if self._remat():
                x = checkpoint(layer, x, positions, chunk,
                               use_reentrant=False)
            else:
                x = layer(x, positions, chunk)
        return _layernorm(x, self.enc_norm, cfg.norm_eps)

    # -- the decoder ------------------------------------------------------------

    def _dec_embed(self, tokens, embeds, start=None):
        """The token rows (or the given ``embeds``) plus the decoder
        positions from 0, or from ``start``, a 0-d tensor on the device,
        clamped so that the rows fit in ``pos_dec``."""
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens= and embeds=")
        x = (embeds.to(self.cfg.torch_dtype) if embeds is not None
             else L.embed_lookup(self.embed, tokens))
        s, n = x.shape[1], self.pos_dec.shape[0]
        if s > n:
            raise ValueError(f"{s} decoder positions; pos_dec holds {n}")
        if start is None:
            pos = self.pos_dec[:s]
        else:
            pos = self.pos_dec[torch.clamp(start, max=n - s).to(torch.int64)
                               + torch.arange(s, device=x.device)]
        return x + pos[None].to(x.dtype)

    def _logits(self, x) -> torch.Tensor:
        x = _layernorm(x, self.dec_norm, self.cfg.norm_eps)
        return L.unembed(x, self.embed, self.cfg.vocab)

    @staticmethod
    def _frames(frame_embeds, prefix_embeds):
        frames = prefix_embeds if frame_embeds is None else frame_embeds
        if frames is None:
            raise ValueError("the encoder takes frame_embeds [B, T_enc, d]")
        return frames

    # -- public entry points --------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens=None, *, embeds=None, frame_embeds=None,
                prefix_embeds=None):
        """Teacher-forced decode over the whole token stream. Returns
        (logits [B, S, V_pad] f32, a zero aux)."""
        return self._forward(tokens, embeds,
                             self._frames(frame_embeds, prefix_embeds))

    def _forward(self, tokens, embeds, frames):
        enc = self.encode(frames)
        x = self._dec_embed(tokens, embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for layer in self.dec_layers:
            if self._remat():
                x = checkpoint(lambda h, e, l=layer: l(h, positions,
                                                       enc=e)[0],
                               x, enc, use_reentrant=False)
            else:
                x, _ = layer(x, positions, enc=enc)
        return self._logits(x), torch.zeros((), dtype=F32, device=x.device)

    def loss(self, tokens, *, frame_embeds=None, prefix_embeds=None):
        """Next-token cross-entropy in float32 over ``tokens`` [B, S] (the
        reference's ``_xent(logits[:, :-1], tokens[:, 1:])``), recorded for
        autograd where grad is enabled. Returns (loss, {})."""
        tokens = tokens.long()
        logits, _ = self._forward(tokens, None,
                                  self._frames(frame_embeds, prefix_embeds))
        return _xent(logits[:, :-1], tokens[:, 1:]), {}

    @torch.no_grad()
    def prefill(self, tokens=None, *, embeds=None, frame_embeds=None,
                prefix_embeds=None, capacity: Optional[int] = None):
        """The encoder, then a causal pass over the tokens: last-position
        logits [B, V_pad] and the filled cache (``capacity`` decoder rows,
        default the sequence length; the cross K/V of every layer)."""
        enc = self.encode(self._frames(frame_embeds, prefix_embeds))
        x = self._dec_embed(tokens, embeds)
        b, s = x.shape[:2]
        cap = s if capacity is None else capacity
        if cap < s:
            raise ValueError(f"capacity {cap} < sequence length {s}")
        positions = torch.arange(s, device=x.device)[None, :]
        cache = self._empty_cache(b, cap, enc.shape[1])
        for i, layer in enumerate(self.dec_layers):
            ck, cv = layer.cross_kv(enc)
            x, (k, v) = layer(x, positions, cross_kv=(ck, cv))
            cache.self_k[i, :, :s] = k
            cache.self_v[i, :, :s] = v
            cache.cross_k[i] = ck
            cache.cross_v[i] = cv
        logits = self._logits(x[:, -1:])[:, 0]
        return logits, cache._replace(length=cache.length + s)

    def init_cache(self, batch: int, capacity: int) -> EncDecCache:
        """An empty cache: ``capacity`` decoder rows, ``encoder_len``
        cross rows."""
        return self._empty_cache(batch, capacity, self.cfg.encoder_len)

    def _empty_cache(self, batch: int, capacity: int,
                     t_enc: int) -> EncDecCache:
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        z = lambda *shape: torch.zeros(shape, dtype=cfg.torch_dtype,
                                       device=self.device)
        sshape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, hd)
        cshape = (cfg.n_layers, batch, t_enc, cfg.n_heads, hd)
        return EncDecCache(
            self_k=z(*sshape), self_v=z(*sshape), cross_k=z(*cshape),
            cross_v=z(*cshape),
            length=torch.zeros((), dtype=torch.int32, device=self.device))

    @torch.no_grad()
    def decode(self, cache: EncDecCache, tokens=None, *, embeds=None,
               write: bool = True):
        """One decode step. tokens [B, 1]. Returns (logits [B, V_pad],
        cache'). ``write=True`` appends the self-attention rows at
        ``cache.length`` (in place); ``write=False`` attends over cache ∪
        self and writes nothing. Both advance the length."""
        x = self._dec_embed(tokens, embeds, cache.length)
        positions = cache.length.reshape(1, 1)
        rows = []
        for i, layer in enumerate(self.dec_layers):
            x, kv = layer(x, positions,
                          cross_kv=(cache.cross_k[i], cache.cross_v[i]),
                          self_cache=(cache.self_k[i], cache.self_v[i]),
                          kv_len=cache.length)
            rows.append(kv)
        logits = self._logits(x)[:, 0]
        if write:
            # the row index stays on the device; clamped to the last row,
            # as dynamic_update_slice clamps its start
            pos = torch.clamp(cache.length, max=cache.self_k.shape[2] - 1)
            pos = pos.reshape(1).to(torch.int64)
            ks = torch.stack([k for k, _ in rows])      # [L, B, 1, KV, hd]
            vs = torch.stack([v for _, v in rows])
            cache.self_k.index_copy_(2, pos, ks.to(cache.self_k.dtype))
            cache.self_v.index_copy_(2, pos, vs.to(cache.self_v.dtype))
        return logits, cache._replace(length=cache.length + 1)
