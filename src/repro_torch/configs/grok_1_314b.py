"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) vocab=131072,
MoE 8 experts top-2, expert width 32768. [hf:xai-org/grok-1; unverified]"""
from repro_torch.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768),
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, attn_chunk=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64),
)
