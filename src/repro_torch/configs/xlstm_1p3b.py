"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks d=2048, 4 heads, 7:1 mLSTM:sLSTM,
vocab=50304; d_ff=0 (projection factors live inside the blocks: mLSTM pf=2,
sLSTM ff pf=4/3)."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, chunk=256),
)
