"""Plain PyTorch version of the flash-attention kernel K6 (the naive
full-score path), line for line ``repro/kernels/flashattn/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        cap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,Kv,hd) -> (B,S,H,hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, S, Kv, rep, hd)
    s = torch.einsum("bqkrh,btkh->bkrqt", qg.float(), k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None] > q_pos[:, None] - window
    s = torch.where(mask[None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bkrqt,btkh->bqkrh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
