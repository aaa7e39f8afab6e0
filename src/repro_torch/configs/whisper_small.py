"""whisper-small [audio]: 12L d_model=768 12H (MHA) d_ff=3072 vocab=51865
— enc-dec, conv frontend STUB (input_specs provides precomputed frame
embeddings [B, 1500, 768]). [arXiv:2212.04356; unverified]"""
from repro_torch.config import ModelConfig

FULL = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, pos_kind="learned",
    n_encoder_layers=12, encoder_len=1500, attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, pos_kind="learned",
    n_encoder_layers=2, encoder_len=30, attn_chunk=16,
)
