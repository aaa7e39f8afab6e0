"""deepseek-v3-671b [moe]: 61L d_model=7168 128H vocab=129280 — MLA
(q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128), 1 shared + 256
routed experts top-8 (expert width 2048; first 3 layers dense d_ff 18432),
MTP depth-1 head. [arXiv:2412.19437; hf]"""
from repro_torch.config import (AttentionKind, MLAConfig, ModelConfig,
                                MoEConfig)

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    attention=AttentionKind.MLA,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  first_dense=3, dense_d_ff=18432),
    mtp=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, attn_chunk=16,
    attention=AttentionKind.MLA,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  first_dense=1, dense_d_ff=96),
    mtp=True,
)
