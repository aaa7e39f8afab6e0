"""The port's copies of ``repro.config.base``'s dataclasses: ``PIRConfig``
and ``MeshConfig``, and the model side (``ModelConfig`` with its MoE, MLA
and SSM blocks, ``ShapeConfig``).

The reference resolves ``share_kind`` through its own protocol registry,
which imports JAX, so the port keeps its own dataclass with the same field
names and defaults: one spec (``dataclasses.asdict`` of either) builds
both sides. ``share_kind`` resolves against ``repro_torch``'s registry.
``MeshConfig`` is the grid ``runtime/elastic.plan_mesh`` returns.

The model-side classes are data, copied field for field so that every
architecture file of the reference can be read here (the MoE, MLA and SSM
families are not served yet). ``ModelConfig.torch_dtype`` maps the
``dtype`` string (``"bfloat16"``, ``"float32"``) to the torch dtype;
``to_dict`` gives the reference's dict (enums as their values).
``OptimizerConfig`` and ``RunConfig`` are the train half's (the serve step
takes a ``ModelConfig`` and a ``ShapeConfig``); ``RunConfig.to_dict`` goes
into every checkpoint's manifest, so it keeps the reference's fields, the
mesh and ``private_embed`` included. ``fsdp=True`` raises: sharding
parameters over several cards is ROADMAP A6b. ``private_embed=True`` and
a ``pir`` raise too: no step reads them (private embedding lookups run
through ``repro_torch.private_inference``).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import asdict, dataclass, field
from typing import Any, Optional, Tuple

import torch


def _implied_share_kind(protocol_name: str) -> str:
    """Share algebra from a protocol name, for names the port has not
    registered yet (the reference's naming convention)."""
    if "additive" in protocol_name:
        return "additive"
    if "lwe" in protocol_name:
        return "lwe"
    return "xor"


@dataclass(frozen=True)
class PIRConfig:
    """One PIR database + protocol choices (same fields as the reference).

    ``mode`` is the reference's deprecated constructor alias; the port
    accepts only its normalized value ``""`` and names schemes by
    ``protocol`` (``""`` means ``xor-dpf-2``).
    """
    n_items: int                   # N: number of DB records (power of two)
    item_bytes: int = 32           # L: record payload (paper: 32-byte hashes)
    mode: str = ""                 # deprecated alias in the reference; "" only
    protocol: str = ""             # registry name; "" -> xor-dpf-2
    n_servers: int = 2             # parties
    clusters: int = 1              # DPU clusters (paper §3.4)
    batch_queries: int = 32        # concurrent queries per step
    prf: str = "chacha12"          # chacha12 | chacha8 | chacha20
    fused_kernel: bool = False     # fused GGM-expand + dpXOR (beyond paper)
    checksum: bool = False         # verified reconstruction (row checksum)
    batch_m: int = 0               # batch PIR: m records per round (BatchPIR)
    cuckoo_c: float = 2.0
    cuckoo_hashes: int = 3
    cuckoo_seed: int = 0x5EEDBA11

    def __post_init__(self):
        if self.mode:
            raise ValueError(
                f"PIRConfig(mode={self.mode!r}) is the reference's deprecated "
                "alias; name the scheme with protocol= instead")
        if not self.protocol:
            object.__setattr__(self, "protocol", "xor-dpf-2")

    @property
    def share_kind(self) -> str:
        """``xor`` | ``additive`` | ``lwe``: the registered protocol's, else
        the naming convention for schemes the port has not registered."""
        from repro_torch.core.protocol import get
        try:
            return get(self.protocol).share_kind
        except KeyError:
            return _implied_share_kind(self.protocol)

    @property
    def log_n(self) -> int:
        return (self.n_items - 1).bit_length()

    @property
    def db_bytes(self) -> int:
        return self.n_items * self.item_bytes

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class MeshConfig:
    """A device grid: axis sizes and names (``("data", "model")``, with a
    leading ``"pod"`` axis for several pods)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def to_dict(self) -> dict:
        return asdict(self)


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {k: _asdict(v) for k, v in asdict(obj).items()}
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


class AttentionKind(str, enum.Enum):
    GQA = "gqa"          # grouped-query attention (MHA when kv == heads)
    MLA = "mla"          # DeepSeek multi-head latent attention
    NONE = "none"        # attention-free block stacks (pure SSM)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block parameters."""
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden width
    n_shared: int = 0              # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25  # per-expert token capacity multiplier
    router_dtype: str = "float32"
    first_dense: int = 0           # layers [0, first_dense) use a dense FFN
    dense_d_ff: int = 0            # width of those dense layers (0 = d_ff)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3) dimensions."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block parameters (Mamba2, xLSTM)."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 256               # chunkwise-parallel scan block length
    shared_attn_every: int = 0     # zamba2: weight-shared attention block
    block_pattern: Tuple[str, ...] = ()   # xlstm: block pattern


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelConfig:
    """One architecture (the reference's fields and defaults)."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    attention: AttentionKind = AttentionKind.GQA
    qk_norm: bool = False
    pos_kind: str = "rope"         # rope | learned (whisper decoder)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_encoder_layers: int = 0      # enc-dec (whisper); 0 = decoder-only
    encoder_len: int = 0
    n_frontend_tokens: int = 0     # modality prefix tokens fed by the client
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp: bool = False              # DeepSeek multi-token-prediction head
    dtype: str = "bfloat16"
    attn_chunk: int = 1024         # attention score block size

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        """The activation and weight dtype ``dtype`` names."""
        try:
            return _TORCH_DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unknown dtype {self.dtype!r}; expected one "
                             f"of {sorted(_TORCH_DTYPES)}") from None

    def n_params(self) -> int:
        """Analytic parameter count (the reference's, term for term)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == AttentionKind.MLA and self.mla is not None:
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += (d * m.q_lora_rank
                          + m.q_lora_rank * self.n_heads * qk_head)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                          + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.attention == AttentionKind.GQA:
            per_layer += d * self.n_heads * hd          # q
            per_layer += 2 * d * self.n_kv_heads * hd   # k, v
            per_layer += self.n_heads * hd * d          # o
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_inner = s.expand * d
            if self.family == "ssm":
                # xlstm: mLSTM ~ in 2.d.di + qkv 3.di^2 + out di.d
                per_layer_ssm = (2 * d * d_inner + 3 * d_inner * d_inner
                                 + d_inner * d)
            else:
                # mamba2: in_proj + conv + out_proj
                hd = s.headdim or max(1, d_inner // max(self.n_heads, 1))
                nh = d_inner // hd
                per_layer_ssm = d * (2 * d_inner + 2 * s.d_state + nh)
                per_layer_ssm += d_inner * d + s.d_conv * (
                    d_inner + 2 * s.d_state)
            # hybrid: the GQA params above belong to the one shared block
            shared_attn = per_layer if self.family == "hybrid" else 0
            per_layer = per_layer_ssm
        if self.moe is not None:
            m = self.moe
            n_moe_layers = self.n_layers - m.first_dense
            ff = 3 * d * m.d_expert
            per_layer_moe = (m.n_experts * ff + m.n_shared * ff
                             + d * m.n_experts)
            dense_ff = 3 * d * (m.dense_d_ff or self.d_ff)
            total_ffn = n_moe_layers * per_layer_moe + m.first_dense * dense_ff
        elif self.family == "hybrid":
            total_ffn = 3 * d * self.d_ff + shared_attn   # weight-tied, once
        elif self.family == "audio":
            total_ffn = ((self.n_layers + self.n_encoder_layers)
                         * 2 * d * self.d_ff)            # GELU two-matrix MLP
        elif self.d_ff > 0:
            total_ffn = self.n_layers * 3 * d * self.d_ff
        else:
            total_ffn = 0
        layers = self.n_layers + self.n_encoder_layers
        return n_emb + layers * per_layer + total_ffn + layers * 2 * d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        ff = 3 * self.d_model * m.d_expert
        n_moe_layers = self.n_layers - m.first_dense
        return self.n_params() - n_moe_layers * (m.n_experts - m.top_k) * ff

    def to_dict(self) -> dict:
        return _asdict(self)


@dataclass(frozen=True)
class ShapeConfig:
    """An input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def to_dict(self) -> dict:
        return _asdict(self)


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # int8 gradient compression with error feedback (cross-pod in the
    # reference; on one card the numerical hook alone)
    compress_grads: bool = False

    def to_dict(self) -> dict:
        return _asdict(self)


@dataclass(frozen=True)
class RunConfig:
    """One training or serving run (the reference's fields and defaults)."""
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    microbatches: int = 1          # gradient-accumulation microbatches
    remat: str = "block"           # none | block (recompute each layer)
    fsdp: bool = False             # parameters sharded over cards: A6b
    private_embed: bool = False    # serve embeddings through PIR
    pir: Optional[PIRConfig] = None
    seed: int = 0

    def __post_init__(self):
        if self.fsdp:
            raise NotImplementedError(
                "fsdp=True shards parameters over several cards, which the "
                "port does not do yet (ROADMAP A6b); it trains on one card")
        if self.private_embed or self.pir is not None:
            raise NotImplementedError(
                "private_embed / pir: no train or serve step reads them; "
                "private embedding lookups run through "
                "repro_torch.private_inference")
        if self.microbatches < 1 or \
                self.shape.global_batch % self.microbatches:
            raise ValueError(
                f"global batch {self.shape.global_batch} does not split "
                f"into {self.microbatches} microbatches")

    def to_dict(self) -> dict:
        return _asdict(self)
