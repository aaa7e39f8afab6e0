"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, attn_chunk=16,
)
