"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32 == MHA) d_ff=6912
vocab=50304. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, attn_chunk=16,
)
