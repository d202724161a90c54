"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; 27B dims per assignment]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),  # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt",
)
