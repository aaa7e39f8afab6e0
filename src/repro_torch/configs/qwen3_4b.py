"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
    head_dim=128,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, qk_norm=True, head_dim=32, attn_chunk=16,
)
