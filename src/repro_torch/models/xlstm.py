"""xLSTM language model: mLSTM / sLSTM residual blocks — the port of
``repro/models/xlstm.py``.

xlstm-350m: 24 blocks, no separate FFN (``d_ff=0``: the up / down
projections live inside the blocks). The block pattern comes from
``cfg.ssm.block_pattern`` (7 mLSTM : 1 sLSTM), repeated over the depth.

``XLSTMModel`` is an ``nn.Module`` whose parameter paths are the
reference's tree: ``embed``, ``blocks.{i}.norm``, ``blocks.{i}.mix.*``
(an mLSTM's ``in_proj``, ``conv_w``, ``wqkv``, ``wif``, ``norm``,
``out_proj``; an sLSTM's ``w_in``, ``r_rec`` (float32 in any model
dtype), ``norm``, ``out_proj``), ``final_norm`` and ``unembed``. The
reference keeps ``blocks`` as a Python list of dicts (the blocks differ
in structure, so nothing is stacked); ``blocks`` here is an
``nn.ModuleList`` of :class:`Block`, and
``convert.model_params_from_reference`` maps ``blocks[i]/mix/w_in`` to
``blocks.{i}.mix.w_in``.

Entry points, as ``TransformerLM``'s: ``init_params(generator)``,
``forward``, ``loss``, ``prefill``, ``init_cache`` and ``decode``.
``forward``, ``prefill`` and ``decode`` also take ``embeds=`` ``[B, S,
d]`` in place of ``tokens`` (the private-embedding twin);
``prefix_embeds=`` is accepted and ignored, as the reference's.
``prefill(capacity=)`` and ``init_cache(batch, capacity)`` ignore the
capacity and ``decode(write=)`` ignores ``write``: the decode state does
not grow with length and always advances. This is why the arch runs the
``long_500k`` cell (``configs.cell_is_skipped``).

The cache (:class:`XLSTMCache`): per block an mLSTM's (conv tail [B, K-1,
d_inner] in the model dtype, matrix state [B·H, 1, P+1, P] float32) or an
sLSTM's (c, n, h, m), each [B, d] float32, and ``length``, a 0-d int32
tensor on the device. ``decode`` returns new tensors and never writes the
cache it was given.

``forward``, ``prefill`` and ``decode`` run without autograd; ``loss``
records it. With ``remat="block"`` each block of a pass that records
autograd is recomputed in the backward pass (``torch.utils.checkpoint``),
as the reference wraps ``_block`` in ``jax.checkpoint``. Prompts must be
at most ``cfg.ssm.chunk`` tokens or a multiple of it (``ssd_scan`` raises
otherwise, as the reference's).

Not ported: ``param_specs`` and ``cache_specs`` (mesh layout).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import _weight, _xent

F32 = torch.float32

_SHAPES = {"mlstm": S.mlstm_shapes, "slstm": S.slstm_shapes}
_INIT = {"mlstm": S.mlstm_init, "slstm": S.slstm_init}
_APPLY = {"mlstm": S.mlstm_apply, "slstm": S.slstm_apply}


class XLSTMCache(NamedTuple):
    blocks: Tuple[tuple, ...]    # per-block caches
    length: torch.Tensor         # [] int32, on the device

    def streams(self, lo: int, hi: int) -> "XLSTMCache":
        """The cache of streams ``lo:hi`` (an mLSTM state's rows are [B·H]:
        stream-major, H rows a stream)."""
        out = []
        for block in self.blocks:
            if len(block) == 2:                       # mLSTM
                conv, state = block
                h = state.shape[0] // conv.shape[0]
                out.append((conv[lo:hi], state[lo * h:hi * h]))
            else:
                out.append(tuple(t[lo:hi] for t in block))
        return self._replace(blocks=tuple(out))

    def nbytes(self) -> int:
        """Bytes of the decode state (every block's tensors)."""
        return sum(t.numel() * t.element_size()
                   for block in self.blocks for t in block)


class Block(nn.Module):
    """One pre-norm residual block: ``norm`` [d] and the mixer ``mix`` (an
    mLSTM's or an sLSTM's parameters)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.norm = _weight(cfg.d_model, dtype=cfg.torch_dtype,
                            device=device)
        self.mix = nn.ParameterDict({
            name: _weight(*shape, dtype=dt, device=device)
            for name, (shape, dt) in _SHAPES[kind](cfg).items()})

    @torch.no_grad()
    def init_params(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.norm.zero_()
        for name, value in _INIT[self.kind](gen, cfg).items():
            self.mix[name].copy_(value)


class XLSTMModel(nn.Module):
    """The xLSTM LM on one device (``device=None`` is the current default
    device; ``registry.build_model`` resolves it)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 remat: str = "block"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat {remat!r}; expected 'none' or "
                             "'block'")
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"{cfg.name!r}: XLSTMModel takes an ssm config "
                             "with ssm=")
        self.cfg = cfg
        self.remat = remat
        pattern = cfg.ssm.block_pattern or ("mlstm", "slstm")
        self.kinds = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
        dt = cfg.torch_dtype
        v_pad = L.pad_vocab(cfg.vocab)
        self.embed = _weight(v_pad, cfg.d_model, dtype=dt, device=device)
        self.blocks = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in self.kinds)
        self.final_norm = _weight(cfg.d_model, dtype=dt, device=device)
        self.unembed = _weight(v_pad, cfg.d_model, dtype=dt, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "XLSTMModel":
        """Draw every weight from ``gen`` (on the module's device): the
        tables normal(0, 0.02), the matrices uniform(±1/sqrt(d_in)),
        ``conv_w`` normal x 0.1, ``r_rec`` uniform(±1/sqrt(d)) x 0.1 in
        float32, the norm scales 0 (``1 + scale`` is applied). Returns the
        module."""
        cfg = self.cfg
        self.embed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                      cfg.torch_dtype))
        for block in self.blocks:
            block.init_params(gen, cfg)
        self.final_norm.zero_()
        self.unembed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                        cfg.torch_dtype))
        return self

    # -- blocks ---------------------------------------------------------------

    def _block(self, block: Block, x, cache=None):
        h = L.rmsnorm(x, block.norm, self.cfg.norm_eps)
        y, new_cache = _APPLY[block.kind](block.mix, self.cfg, h,
                                          cache=cache)
        return x + y, new_cache

    def _embed(self, tokens, embeds):
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens= and embeds=")
        return (embeds.to(self.cfg.torch_dtype) if embeds is not None
                else L.embed_lookup(self.embed, tokens))

    def _logits(self, x) -> torch.Tensor:
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return L.unembed(x, self.unembed, self.cfg.vocab)

    # -- public entry points --------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens=None, *, embeds=None, prefix_embeds=None):
        """Full-sequence pass. Returns (logits [B, S, V_pad] f32, a zero
        aux). ``prefix_embeds`` is ignored, as the reference's."""
        del prefix_embeds
        return self._forward(tokens, embeds)

    def _forward(self, tokens, embeds):
        x = self._embed(tokens, embeds)
        remat = self.remat == "block" and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint(lambda h, b=block: self._block(b, h)[0], x,
                               use_reentrant=False)
            else:
                x, _ = self._block(block, x)
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
        cache. ``capacity`` and ``prefix_embeds`` are ignored."""
        del prefix_embeds, capacity
        x = self._embed(tokens, embeds)
        caches = []
        for block in self.blocks:
            x, c = self._block(block, x)
            caches.append(c)
        logits = self._logits(x[:, -1:])[:, 0]
        length = torch.full((), x.shape[1], dtype=torch.int32,
                            device=x.device)
        return logits, XLSTMCache(blocks=tuple(caches), length=length)

    @torch.no_grad()
    def decode(self, cache: XLSTMCache, tokens=None, *, embeds=None,
               write: bool = True):
        """One decode step, tokens [B, 1]. Returns (logits [B, V_pad], the
        advanced cache). ``write`` is ignored: the recurrent state always
        advances; the given cache is not written."""
        del write
        x = self._embed(tokens, embeds)
        new = []
        for block, c in zip(self.blocks, cache.blocks):
            x, nc = self._block(block, x, cache=c)
            new.append(nc)
        logits = self._logits(x)[:, 0]
        return logits, XLSTMCache(blocks=tuple(new),
                                  length=cache.length + 1)

    def init_cache(self, batch: int, capacity: int) -> XLSTMCache:
        """A zero cache for ``batch`` streams; ``capacity`` is ignored (the
        state does not grow with length)."""
        del capacity
        caches = []
        for kind in self.kinds:
            init = (S.mlstm_cache_init if kind == "mlstm"
                    else S.slstm_cache_init)
            caches.append(init(self.cfg, batch, device=self.device))
        return XLSTMCache(blocks=tuple(caches),
                          length=torch.zeros((), dtype=torch.int32,
                                             device=self.device))
