"""zamba2-7b [hybrid]: 81L d_model=3584 32H d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 trunk + weight-shared attention block every 6 layers.
[arXiv:2411.15242; unverified]"""
from repro_torch.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, chunk=256,
                  shared_attn_every=6),
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, attn_chunk=16,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=16, chunk=16,
                  shared_attn_every=2),
)
