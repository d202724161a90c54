"""whisper-large-v3 [audio] — enc-dec transformer backbone; the mel+conv
frontend is a STUB (input_specs supplies precomputed frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,              # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq_len=1500,         # 30s audio after conv frontend (stub)
    frontend_dim=1280,
    window_pattern=(),            # full attention -> long_500k skipped
    citation="arXiv:2212.04356",
)
