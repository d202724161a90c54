"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.

Assignment note: the line reads "MoE 64e top-6 ... 2 shared+160 routed top-6";
160 routed belongs to full DeepSeek-V2 — the Lite model (and the leading
"64e") has 64 routed experts, which we follow.  [arXiv:2405.04434]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                    # per-expert FFN dim
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    head_dim=192,                 # nope + rope
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    rope_theta=10_000.0,
    citation="arXiv:2405.04434",
)
