"""Decoder-only transformer LM, dense, MoE and VLM families, GQA or MLA —
the port of ``repro/models/transformer.py``.

``TransformerLM`` is an ``nn.Module``: the token table, the layer stacks,
the final norm, the (untied) unembedding table and, with ``cfg.mtp``,
DeepSeek-V3's depth-1 multi-token-prediction head, every weight in the
reference's ``x @ W`` orientation. A MoE config splits the stack as the
reference does: a dense prefix of ``moe.first_dense`` layers
(``layers.{i}``, the reference's ``dense_layers``; every layer of a dense
config) and the MoE trunk (``moe_layers.{j}``), each an ``nn.ModuleList``
of :class:`Block`; the MTP head is ``mtp.{proj,norm,layer}``. Where the
reference scans layer parameters stacked on a leading ``[L, ...]`` axis,
the port loops over the blocks; ``convert.model_params_from_reference``
unstacks the reference's tree into this module's state.

Entry points (as the reference's, with the weights held by the module):
  init_params(generator)         draw the weights (an explicit generator)
  forward(tokens)                full-sequence causal logits and the aux
  loss(tokens)                   next-token cross-entropy (+ aux, + MTP),
                                 grad enabled
  prefill(tokens)                last-position logits + the filled cache
  init_cache(batch, capacity)    a preallocated, empty cache
  decode(cache, tokens)          one token against the cache
``forward``, ``prefill`` and ``decode`` also take ``embeds=`` (``[B, S,
d]``) in place of ``tokens``: a pass that starts from client-side
embeddings (the private embedding lookup), as
``examples/private_inference.py`` runs the reference's layer stack.

``forward``, ``loss`` and ``prefill`` take ``prefix_embeds=`` (``[B, P,
d]``, the VLM's patch embeddings; any float dtype, cast to the model's):
the rows are put ahead of the token (or given) embeddings, so positions
start at 0 on the first prefix row. The logits cover prefix and tokens;
``loss`` predicts ``tokens[:, 1:]`` from the logits at the token
positions only, so no loss falls on a prefix position; the prefill's
cache holds P + S rows and its ``length`` is P + S, from which ``decode``
continues.

``forward``, ``prefill`` and ``decode`` run without autograd; ``loss``
records it. Parameters are created with ``requires_grad=False``: the train
step (``runtime/steps.make_train_step``) turns it on for its own model.
With ``remat="block"`` (the reference's default) a pass that records
autograd keeps only each block's input and recomputes the block in the
backward pass (``torch.utils.checkpoint``), over both stacks, as the
reference wraps its scanned layer body in ``jax.checkpoint``;
``remat="none"`` keeps every activation.

The KV cache covers every layer, the dense prefix first: for GQA k and v
are ``[L, B, C, KV, hd]``; for MLA k holds the compressed rows ``[L, B, C,
kv_lora + rope]`` and v is empty (``[L, B, 0]``, so that a stream's slice
is taken alike for both kinds). ``length`` is a 0-d int32 tensor on the
device, read there (positions, masks, the write row) so that a decode step
never waits for the card. ``prefill(capacity=)`` extends the reference: it
allocates C >= S rows (the rows past S zero), so that ``decode(write=True)``
has room to append; without it the cache holds exactly S rows, as the
reference's. Like ``jax.lax.dynamic_update_slice``, a write past the
capacity lands on the last row.

``decode`` updates the cache's tensors in place (the reference donates the
cache to its decode step) and returns a cache with the new length. A MoE
decode step routes its tokens as ``moe.moe_apply`` chooses (batch-global
dispatch or the per-token gather), which never drops a slot, where the
forward's per-sequence dispatch may: for MoE, a cached decode need not
equal the forward, in the reference too.

Not ported: the ``*_specs`` (mesh layout; ROADMAP A6b).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import AttentionKind, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M

F32 = torch.float32

#: the families this module serves (``registry.build_model``'s)
PORTED_FAMILIES = ("dense", "moe", "vlm")


class KVCache(NamedTuple):
    """Preallocated decode cache. GQA: k / v [Layers, B, C, KV, hd]; MLA:
    k holds the compressed rows [Layers, B, C, kv_lora + rope], v is an
    empty [Layers, B, 0]."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor    # [] int32 — valid prefix, on the cache's device


def _weight(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MoE(nn.Module):
    """One layer's experts: the reference's ``moe_init`` tree as
    parameters (``router`` [d, E] float32, ``gate`` / ``up`` [E, d, f],
    ``down`` [E, f, d], and ``shared.{gate,up,down}`` with shared
    experts). Calling it on ``[B, S, d]`` runs ``moe.moe_apply``:
    (out, aux)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        m, d, dt = cfg.moe, cfg.d_model, cfg.torch_dtype
        e, f = m.n_experts, m.d_expert
        w = lambda *shape: _weight(*shape, dtype=dt, device=device)
        self.router = _weight(d, e, dtype=F32, device=device)
        self.gate = w(e, d, f)
        self.up = w(e, d, f)
        self.down = w(e, f, d)
        ff = m.n_shared * f
        self.shared = nn.ParameterDict(
            {"gate": w(d, ff), "up": w(d, ff), "down": w(ff, d)}
        ) if m.n_shared else None

    def params(self) -> dict:
        """The tree ``moe.moe_apply`` takes (the module's own tensors)."""
        p = {"router": self.router, "gate": self.gate, "up": self.up,
             "down": self.down}
        if self.shared is not None:
            p["shared"] = self.shared
        return p

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """As ``moe.moe_init``, each expert drawn in place."""
        cfg = self.cfg
        self.router.copy_(L.dense_init(gen, cfg.d_model, cfg.moe.n_experts,
                                       F32))
        for w in (self.gate, self.up, self.down):
            M.init_experts_(w, gen)
        if self.shared is not None:
            ff = self.shared["down"].shape[0]
            for k, v in L.mlp_init(gen, cfg.d_model, ff,
                                   cfg.torch_dtype).items():
                self.shared[k].copy_(v)

    def forward(self, x):
        return M.moe_apply(self.params(), self.cfg, x)


class Block(nn.Module):
    """One pre-norm layer (the reference's ``_layer_init`` / ``_layer``):
    GQA or MLA attention, then the SwiGLU MLP (``moe.dense_d_ff`` wide
    in a MoE config's dense layers) or, with ``moe_layer``, :class:`MoE`."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 moe_layer: bool = False):
        super().__init__()
        self.cfg = cfg
        self.moe_layer = moe_layer
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd, dt = cfg.resolved_head_dim, cfg.torch_dtype
        w = lambda *shape: _weight(*shape, dtype=dt, device=device)
        self.ln1 = w(d)
        self.ln2 = w(d)
        if cfg.attention == AttentionKind.MLA:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = {"wq_a": w(d, m.q_lora_rank),
                    "wq_b": w(m.q_lora_rank, h * qk),
                    "wkv_a": w(d, m.kv_lora_rank + m.qk_rope_head_dim),
                    "wkv_b": w(m.kv_lora_rank,
                               h * (m.qk_nope_head_dim + m.v_head_dim)),
                    "wo": w(h * m.v_head_dim, d),
                    "q_a_norm": w(m.q_lora_rank),
                    "kv_a_norm": w(m.kv_lora_rank)}
        else:
            attn = {"wq": w(d, h * hd), "wk": w(d, kv * hd),
                    "wv": w(d, kv * hd), "wo": w(h * hd, d)}
            if cfg.qk_norm:
                attn.update(q_norm=w(hd), k_norm=w(hd))
        self.attn = nn.ParameterDict(attn)
        if moe_layer:
            self.ffn = MoE(cfg, device)
        else:
            d_ff = self.dense_d_ff(cfg)
            self.ffn = nn.ParameterDict(
                {"gate": w(d, d_ff), "up": w(d, d_ff), "down": w(d_ff, d)})

    @staticmethod
    def dense_d_ff(cfg: ModelConfig) -> int:
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            return cfg.moe.dense_d_ff
        return cfg.d_ff

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        self.ln1.zero_()
        self.ln2.zero_()
        init = L.mla_init if cfg.attention == AttentionKind.MLA \
            else L.gqa_init
        for k, v in init(gen, cfg).items():
            self.attn[k].copy_(v)
        if self.moe_layer:
            self.ffn.init_params(gen)
            return
        for k, v in L.mlp_init(gen, cfg.d_model, self.dense_d_ff(cfg),
                               cfg.torch_dtype).items():
            self.ffn[k].copy_(v)

    def forward(self, x, positions, *, kv_cache=None, kv_len=None):
        """Returns (x', the new cache rows, aux): the rows are (k_new,
        v_new) for GQA and the compressed row for MLA; aux is the MoE
        load-balance loss, None in a dense layer."""
        cfg = self.cfg
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        attend = L.mla_attend if cfg.attention == AttentionKind.MLA \
            else L.gqa_attend
        attn_out, kv_new = attend(self.attn, cfg, h, positions,
                                  kv_cache=kv_cache, kv_len=kv_len)
        x = x + attn_out
        h = L.rmsnorm(x, self.ln2, cfg.norm_eps)
        if self.moe_layer:
            y, aux = self.ffn(h)
            return x + y, kv_new, aux
        return x + L.mlp_apply(self.ffn, h), kv_new, None


class MTPHead(nn.Module):
    """DeepSeek-V3's depth-1 MTP head: ``proj`` [2d, d], ``norm`` [d] and
    one dense ``layer``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.proj = _weight(2 * cfg.d_model, cfg.d_model, dtype=dt,
                            device=device)
        self.norm = _weight(cfg.d_model, dtype=dt, device=device)
        self.layer = Block(cfg, device)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        d = self.norm.shape[0]
        self.proj.copy_(L.dense_init(gen, 2 * d, d, self.proj.dtype))
        self.norm.zero_()
        self.layer.init_params(gen)


class TransformerLM(nn.Module):
    """The decoder-only LM (dense or MoE, GQA or MLA) on one device
    (``device=None`` is the current default device;
    ``registry.build_model`` resolves it)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 remat: str = "block"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat {remat!r}; expected 'none' or "
                             "'block'")
        self.remat = remat
        if cfg.family not in PORTED_FAMILIES or cfg.attention not in (
                AttentionKind.GQA, AttentionKind.MLA):
            raise NotImplementedError(
                f"TransformerLM serves the {PORTED_FAMILIES} families with "
                f"GQA or MLA; {cfg.name!r} is {cfg.family!r} / "
                f"{cfg.attention.value!r}, not ported yet")
        if cfg.family == "moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name!r}: a moe family config needs moe=")
        if cfg.attention == AttentionKind.MLA and cfg.mla is None:
            raise ValueError(f"{cfg.name!r}: MLA attention needs mla=")
        self.cfg = cfg
        self.n_dense = cfg.moe.first_dense if cfg.moe else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense
        dt = cfg.torch_dtype
        v_pad = L.pad_vocab(cfg.vocab)
        self.embed = _weight(v_pad, cfg.d_model, dtype=dt, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(self.n_dense))
        self.moe_layers = nn.ModuleList(
            Block(cfg, device, moe_layer=True) for _ in range(self.n_moe))
        self.final_norm = _weight(cfg.d_model, dtype=dt, device=device)
        self.unembed = (None if cfg.tie_embeddings else
                        _weight(v_pad, cfg.d_model, dtype=dt, device=device))
        self.mtp = MTPHead(cfg, device) if cfg.mtp else None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def blocks(self) -> List[Block]:
        """Every layer in order: the dense prefix, then the MoE trunk."""
        return list(self.layers) + list(self.moe_layers)

    # -- parameters ---------------------------------------------------------

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "TransformerLM":
        """Draw every weight from ``gen`` (on the module's device): the
        tables normal(0, 0.02), the matrices uniform(±1/sqrt(d_in)) (each
        expert drawn on its own), the norm scales 0 (``1 + scale`` is
        applied). Returns the module."""
        cfg = self.cfg
        self.embed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                      cfg.torch_dtype))
        for block in self.blocks:
            block.init_params(gen)
        self.final_norm.zero_()
        if self.unembed is not None:
            self.unembed.copy_(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                            cfg.torch_dtype))
        if self.mtp is not None:
            self.mtp.init_params(gen)
        return self

    # -- layer stack ----------------------------------------------------------

    def _layer_cache(self, cache: Optional[KVCache], i: int):
        if cache is None:
            return None
        if self.cfg.attention == AttentionKind.MLA:
            return cache.k[i]
        return cache.k[i], cache.v[i]

    def _scan_stack(self, x, positions, *, cache: Optional[KVCache] = None,
                    kv_len=None, want_cache: bool = True
                    ) -> Tuple[torch.Tensor, list, torch.Tensor]:
        """Run both stacks in order (cache rows at their layer's offset).
        Returns (x, per-layer cache rows, empty when ``want_cache`` is
        False, the summed aux)."""
        rows = []
        aux = torch.zeros((), dtype=F32, device=x.device)
        remat = self.remat == "block" and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat and cache is None and not want_cache:
                x, a = checkpoint(lambda h, b=block: b(h, positions)[::2], x,
                                  use_reentrant=False)
            else:
                x, kv_new, a = block(x, positions,
                                     kv_cache=self._layer_cache(cache, i),
                                     kv_len=kv_len)
                if want_cache:
                    rows.append(kv_new)
            if a is not None:
                aux = aux + a
        return x, rows, aux

    # -- embeddings -----------------------------------------------------------

    def _embed(self, tokens, embeds, prefix_embeds=None):
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens= and embeds=")
        dt = self.cfg.torch_dtype
        x = (embeds.to(dt) if embeds is not None
             else L.embed_lookup(self.embed, tokens))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dt), x], dim=1)
        return x

    def _unembed_table(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed

    def _logits(self, x) -> torch.Tensor:
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return L.unembed(x, self._unembed_table(), self.cfg.vocab)

    # -- public entry points --------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens=None, *, embeds=None, prefix_embeds=None):
        """Full-sequence causal pass. Returns (logits [B,P+S,V_pad] f32,
        aux): aux is the MoE layers' summed load-balance loss (0 when
        dense)."""
        return self._forward(tokens, embeds, prefix_embeds)

    def _forward(self, tokens, embeds, prefix_embeds=None):
        x = self._embed(tokens, embeds, prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _, aux = self._scan_stack(x, positions, want_cache=False)
        return self._logits(x), aux

    def loss(self, tokens, *, prefix_embeds=None, aux_weight: float = 0.01):
        """Next-token cross-entropy in float32 over ``tokens`` [B, S] (the
        S - 1 predictions from the token positions; none from a
        ``prefix_embeds`` row) + ``aux_weight`` x the aux loss (+ 0.3 x
        the MTP head's cross-entropy with ``cfg.mtp``), recorded for
        autograd where grad is enabled. Returns (total, {"ce", "aux"[,
        "mtp_ce"]})."""
        tokens = tokens.long()
        logits, aux = self._forward(tokens, None, prefix_embeds)
        n_prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        ce = _xent(logits[:, n_prefix:-1], tokens[:, 1:])
        total = ce + aux_weight * aux
        metrics = {"ce": ce, "aux": aux}
        if self.mtp is not None:
            mtp_ce = self._mtp_loss(tokens)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def _mtp_loss(self, tokens):
        """DeepSeek-V3 depth-1 MTP: h'_t = Layer(W [norm(emb(x_t));
        emb(x_{t+1})]) predicts x_{t+2}; the unembedding is shared. As
        the reference, it reads the embedding stream, not the trunk's
        output."""
        cfg = self.cfg
        x = L.embed_lookup(self.embed, tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h = L.rmsnorm(x[:, :-1], self.mtp.norm, cfg.norm_eps)
        fused = torch.cat([h, x[:, 1:]], dim=-1) @ self.mtp.proj
        fused, _, _ = self.mtp.layer(fused, positions[:, :-1])
        mtp_logits = L.unembed(fused, self._unembed_table(), cfg.vocab)
        return _xent(mtp_logits[:, :-1], tokens[:, 2:])

    @torch.no_grad()
    def prefill(self, tokens=None, *, embeds=None, prefix_embeds=None,
                capacity: Optional[int] = None):
        """Causal pass returning last-position logits [B, V_pad] and the
        filled cache (``capacity`` rows, default the sequence length, the
        prefix's rows included)."""
        x = self._embed(tokens, embeds, prefix_embeds)
        b, s = x.shape[:2]
        cap = s if capacity is None else capacity
        if cap < s:
            raise ValueError(f"capacity {cap} < sequence length {s}")
        positions = torch.arange(s, device=x.device)[None, :]
        x, rows, _ = self._scan_stack(x, positions)
        logits = self._logits(x[:, -1:])[:, 0]
        cache = self.init_cache(b, cap)
        for i, row in enumerate(rows):
            if self.cfg.attention == AttentionKind.MLA:
                cache.k[i, :, :s] = row
            else:
                cache.k[i, :, :s] = row[0]
                cache.v[i, :, :s] = row[1]
        return logits, cache._replace(length=cache.length + s)

    def init_cache(self, batch: int, capacity: int) -> KVCache:
        cfg = self.cfg
        length = torch.zeros((), dtype=torch.int32, device=self.device)
        z = lambda *shape: torch.zeros(shape, dtype=cfg.torch_dtype,
                                       device=self.device)
        if cfg.attention == AttentionKind.MLA:
            m = cfg.mla
            return KVCache(k=z(cfg.n_layers, batch, capacity,
                               m.kv_lora_rank + m.qk_rope_head_dim),
                           v=z(cfg.n_layers, batch, 0), length=length)
        shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return KVCache(k=z(*shape), v=z(*shape), length=length)

    @torch.no_grad()
    def decode(self, cache: KVCache, tokens=None, *, embeds=None,
               write: bool = True):
        """One decode step. tokens [B, 1]. Returns (logits [B,V_pad],
        cache').

        ``write=True`` appends the new cache rows at ``cache.length`` (in
        place); ``write=False`` attends over cache ∪ self via the
        score-append path and writes nothing. Both advance the length.
        """
        x = self._embed(tokens, embeds)
        positions = cache.length.reshape(1, 1)
        x, rows, _ = self._scan_stack(x, positions, cache=cache,
                                      kv_len=cache.length, want_cache=write)
        logits = self._logits(x)[:, 0]
        if write:
            return logits, self._write_rows(cache, rows)
        return logits, cache._replace(length=cache.length + 1)

    def _write_rows(self, cache: KVCache, rows) -> KVCache:
        # the row index stays on the device; clamped to the last row, as
        # dynamic_update_slice clamps its start
        pos = torch.clamp(cache.length, max=cache.k.shape[2] - 1).reshape(1)
        pos = pos.to(torch.int64)
        if self.cfg.attention == AttentionKind.MLA:
            ks = torch.stack(rows)                     # [L, B, 1, lora+rope]
            cache.k.index_copy_(2, pos, ks.to(cache.k.dtype))
        else:
            ks = torch.stack([k for k, _ in rows])      # [L, B, 1, KV, hd]
            vs = torch.stack([v for _, v in rows])
            cache.k.index_copy_(2, pos, ks.to(cache.k.dtype))
            cache.v.index_copy_(2, pos, vs.to(cache.v.dtype))
        return cache._replace(length=cache.length + 1)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32. logits [B, S, V], targets [B, S]."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - picked)
