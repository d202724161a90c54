"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,                       # no separate FFN: the mamba block is the layer
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    citation="arXiv:2405.21060",
)
