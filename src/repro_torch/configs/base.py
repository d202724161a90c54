"""Architecture + input-shape configuration schema (a copy of
``repro/configs/base.py``: pure data, shared by both packages' tests)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture.  Fields default to "off"; each family uses a subset."""
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads

    # --- attention flavour ---
    # per-layer window pattern, repeated over the stack: each entry is a
    # sliding-window size or None (global).  () => all-global.
    window_pattern: Tuple[Optional[int], ...] = ()
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    use_post_norms: bool = False      # gemma2-style post-block RMSNorm
    tie_embeddings: bool = False

    # --- MLA (deepseek-style multi-head latent attention) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    num_experts: int = 0              # routed experts (0 => dense FFN)
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0                # d_state (0 => no ssm)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # --- hybrid (hymba): parallel attention + ssm heads in each layer ---
    hybrid: bool = False

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq_len: int = 0          # frames after the (stubbed) conv frontend
    frontend_dim: int = 0             # embedding dim the stub frontend emits

    # --- VLM ---
    num_patches: int = 0              # patch embeddings prepended per sample
    vit_dim: int = 0                  # stub vision encoder output dim

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    citation: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and not self.hybrid

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode memory: SSM/hybrid, or every attention layer
        windowed OR the arch mixes windowed layers with O(seq)-decode global
        layers (gemma-style) — what we exclude is *pure* full attention."""
        if self.ssm_state > 0:
            return True
        return bool(self.window_pattern) and any(
            w is not None for w in self.window_pattern)

    def layer_windows(self) -> Tuple[Optional[int], ...]:
        """Expanded per-layer window sizes (len == num_layers)."""
        if not self.window_pattern:
            return (None,) * self.num_layers
        reps = -(-self.num_layers // len(self.window_pattern))
        return (self.window_pattern * reps)[: self.num_layers]

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/flavour, tiny dims (<=2 layers,
        d_model<=512, <=4 experts)."""
        pat = self.window_pattern
        if pat:
            pat = tuple((min(w, 16) if w else None) for w in pat[:2])
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            window_pattern=pat,
            kv_lora_rank=min(self.kv_lora_rank, 64) if self.use_mla else 0,
            qk_rope_head_dim=32 if self.use_mla else self.qk_rope_head_dim,
            qk_nope_head_dim=32 if self.use_mla else self.qk_nope_head_dim,
            v_head_dim=64 if self.use_mla else self.v_head_dim,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 32),
            frontend_dim=min(self.frontend_dim, 256) if self.frontend_dim else 0,
            num_patches=min(self.num_patches, 8),
            vit_dim=min(self.vit_dim, 128) if self.vit_dim else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
