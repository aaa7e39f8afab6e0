"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling frontend is a STUB: input_specs provides
precomputed patch embeddings (2880 tokens = 576 base + 4x576 anyres tiles)
prepended to the text stream. [hf:llava-hf/llava-v1.6-34b-hf, the
Yi-34B language model's config]"""
from repro_torch.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, n_frontend_tokens=2880,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, n_frontend_tokens=8, attn_chunk=16,
)
