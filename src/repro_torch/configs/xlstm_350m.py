"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM per the xLSTM paper's LM configs;
up/down projections live inside the blocks, hence d_ff=0).
[arXiv:2405.04517; unverified]"""
from repro_torch.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm=SSMConfig(d_state=0, d_conv=4, expand=2, headdim=0, chunk=256,
                  block_pattern=("mlstm",) * 7 + ("slstm",)),
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512,
    ssm=SSMConfig(d_state=0, d_conv=4, expand=2, headdim=0, chunk=16,
                  block_pattern=("mlstm", "slstm")),
)
