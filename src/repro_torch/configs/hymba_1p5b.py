"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.
Deviation noted in DESIGN.md: meta-tokens omitted; attention branch uses
uniform SWA (the SSM branch supplies global context, per the paper's design
argument).  [arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    window_pattern=(1024,),       # SWA attention branch
    citation="arXiv:2411.13676",
)
