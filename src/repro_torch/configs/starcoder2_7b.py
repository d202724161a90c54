"""starcoder2-7b [dense] — GQA, RoPE, sliding-window attention.
[arXiv:2402.19173]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    window_pattern=(4096,),       # uniform sliding window
    rope_theta=1_000_000.0,
    citation="arXiv:2402.19173",
)
