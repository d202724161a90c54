"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 routed experts top-8.
[arXiv:2501.kimi2 per assignment]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                    # per-expert FFN dim
    vocab_size=163840,
    num_experts=384,
    num_experts_per_tok=8,
    num_shared_experts=1,
    rope_theta=50_000.0,
    citation="arXiv:2501.kimi2",
)
