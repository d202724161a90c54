"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window_pattern=(4096, None),  # alternating local:global
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norms=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    citation="arXiv:2408.00118",
)
