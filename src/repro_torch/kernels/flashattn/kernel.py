"""Wrapper of the CUDA flash-attention kernel K6 (``csrc/flash_attn.cu``).

K6 replaces ``repro/kernels/flashattn/kernel.py::flash_attention_pallas``:
forward-only causal (optionally windowed, optionally soft-capped) GQA
attention with an online softmax and f32 accumulators.  At the serving
path's prefill shapes it is bound by device-memory bytes; at long sequences
by tensor-core operations.  The design notes are in the source.  Ragged S
and T are masked inside the kernel, so this wrapper pads nothing (the
reference's ``ops.py`` pads to its block size).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flashattn.ref import flash_attention_ref

HEAD_DIMS = (64, 128, 256)    # csrc/flash_attn.cu's template instances


def check_attention(q, k, v, window: Optional[int],
                    cap: Optional[float]) -> None:
    """Validate the operands of K6 and its plain version alike."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, len, heads, hd), got "
                             f"shape {tuple(x.shape)}")
        if x.dtype not in build.DTYPE_CODES:
            raise ValueError(f"flash attention takes "
                             f"{list(build.DTYPE_CODES)}, got {name} "
                             f"{x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    B, S, H, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head_dim")
    if min(B, S, H, k.shape[1], k.shape[2]) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"GQA needs H % Kv == 0, got H={H}, "
                         f"Kv={k.shape[2]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if cap is not None and not cap > 0:
        raise ValueError(f"cap must be > 0 or None, got {cap}")


def _check_cuda_layout(q, k, v) -> None:
    """The kernel reads rows of hd elements with 16-byte loads: each operand
    needs a unit last stride, a 16-byte aligned base and the other strides
    a multiple of 16 bytes."""
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride over head_dim, got "
                             f"strides {x.stride()}")
        # a fake tensor (the dry run's) has no storage to be aligned
        if any(s % vec for s in x.stride()[:3]) or (
                not build.is_fake(x) and x.data_ptr() % 16):
            raise ValueError(f"{name} needs 16-byte aligned rows (strides "
                             f"{x.stride()}, {x.element_size()}-byte "
                             "elements)")


def flash_attention_hopper(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None,
                           cap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,Kv,hd) of f32/f16/bf16 -> (B,S,H,hd) in q's
    dtype; query i and key j sit at positions i and j.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises; a fake one only counts the kernel's cost
    (``build.launch_flash``).  ``flash_attention_hopper.launches`` counts
    kernel launches.
    """
    check_attention(q, k, v, window, cap)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, scale=scale)
    _check_cuda_layout(q, k, v)
    out = build.launch_flash(q, k, v, causal=causal, window=window, cap=cap,
                             scale=scale)
    if not build.is_fake(q):
        flash_attention_hopper.launches += 1
    return out


flash_attention_hopper.launches = 0
