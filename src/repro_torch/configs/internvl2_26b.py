"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2 backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    window_pattern=(),            # full attention -> long_500k skipped
    num_patches=256,              # patch embeddings per sample (stub ViT)
    vit_dim=3200,                 # InternViT-6B output dim
    rope_theta=1_000_000.0,
    citation="arXiv:2404.16821",
)
