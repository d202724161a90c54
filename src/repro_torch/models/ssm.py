"""Mamba2 SSD (state-space duality) block, a port of ``repro/models/ssm.py``.

Training and prefill use the chunked SSD decomposition (Dao & Gu 2024, §6):
quadratic within a chunk, linear across chunks; decode uses the O(1)
recurrent state update, written into the cache in place as the attention
caches of ``models/common.py`` are.  The reference has no kernel here
(pure JAX), so this is a composite of torch ops.

Shapes: x (B,S,d_model); heads H = d_inner/head_dim, state N, head dim P;
the B/C projections are shared across heads (ngroups=1).  ``dt_bias``,
``A_log`` and ``D`` are f32 whatever the model dtype, as in the reference.

Two contractions the reference writes as three-operand einsums are taken
in two steps here, so that no (b, c, s, h, p, n) intermediate is built at
full width: the decay factor is applied to one operand first.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common as C

SSD_CHUNK = 256


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads


def init_mamba(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    dt, dev = C.dtype_of(cfg), gen.device
    d, n, w = cfg.d_model, cfg.ssm_state, cfg.ssm_conv_width
    d_inner, nheads = _dims(cfg)
    conv_ch = d_inner + 2 * n
    d_in_proj = 2 * d_inner + 2 * n + nheads          # z, x, B, C, dt
    conv_w = torch.randn(lead + (w, conv_ch), generator=gen, dtype=dt,
                         device=dev)
    u = torch.rand(lead + (nheads,), generator=gen, dtype=torch.float32,
                   device=dev)
    return {
        "in_proj": C.init_linear(gen, d, d_in_proj, dt, lead),
        "conv_w": conv_w.mul_(1.0 / math.sqrt(w)),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=dev),
        "dt_bias": torch.full(lead + (nheads,), math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=dev),
        "A_log": torch.log(1.0 + 15.0 * u),
        "D": torch.ones(lead + (nheads,), dtype=torch.float32, device=dev),
        "norm": C.init_norm(d_inner, dt, lead, dev),
        "out_proj": C.init_linear(gen, d_inner, d, dt, lead),
    }


def init_mamba_cache(cfg, batch: int, lead: tuple = (), device=None) -> dict:
    """Conv history in the model dtype, SSM state in f32."""
    d_inner, nheads = _dims(cfg)
    conv_ch = d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=C.dtype_of(cfg), device=device),
        "ssm": torch.zeros(lead + (batch, nheads, cfg.ssm_head_dim,
                                   cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv as width-many shifted adds.  x: (B,S,C)."""
    width, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., T) -> (..., T, T) with out[i,j] = sum a[j+1..i], -inf above
    the diagonal.  The mask is applied before the caller's exp, so the
    masked entries' gradients are zeros, not NaN."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(xbar, dA, B, C_, *, chunk: int = SSD_CHUNK,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  xbar: (b,S,h,p) dt-scaled inputs; dA: (b,S,h); B/C_:
    (b,S,n).  Returns (y (b,S,h,p), final_state (b,h,p,n)), f32
    throughout.  A length that is not a multiple of ``chunk`` runs as one
    chunk, as in the reference."""
    b, S, h, p = xbar.shape
    n = B.shape[-1]
    if S % chunk:
        chunk = S                                      # degenerate: one chunk
    nc = S // chunk
    xc = xbar.reshape(b, nc, chunk, h, p).float()
    Ac = dA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)    # (b,h,nc,cs)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C_.reshape(b, nc, chunk, n).float()

    A_cum = torch.cumsum(Ac, dim=-1)                   # (b,h,nc,cs)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(Ac))                         # (b,h,nc,cs,cs)
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)        # (b,nc,cs,cs)
    M = G[:, None] * L                                 # (b,h,nc,cs,cs)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", M, xc)

    # 2. per-chunk final states (no carry-in):
    #    "bcsn,bhcs,bcshp->bchpn" with the decay applied to x first
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)  # (b,h,nc,cs)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, xd)

    # 3. cross-chunk recurrence
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                 device=xbar.device)
    states = torch.cat([init_state[:, None].float(), states], dim=1)
    chunk_sum = A_cum[..., -1]                         # (b,h,nc)
    decay_chunk = torch.exp(_segsum(F.pad(chunk_sum, (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states_in, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output contribution:
    #    "bcln,bchpn,bhcl->bclhp" with the decay applied to the product
    state_decay = torch.exp(A_cum)                     # (b,h,nc,cs)
    Y_off = (torch.einsum("bcln,bchpn->bclhp", Cc, states_in)
             * state_decay.permute(0, 2, 3, 1)[..., None])

    y = (Y_diag + Y_off).reshape(b, S, h, p)
    return y, final_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no switch
    to x at large inputs (torch's ``softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_block(p, cfg, x, *, cache: Optional[dict] = None):
    """Mamba2 block.  Training/prefill when cache is None; one decode step
    (S == 1) otherwise, which writes the conv history and the SSM state into
    ``cache`` in place.  Returns (out (B,S,d), cache)."""
    B_, S, d = x.shape
    n, width = cfg.ssm_state, cfg.ssm_conv_width
    d_inner, nheads = _dims(cfg)
    hp = cfg.ssm_head_dim

    zxbcdt = C.linear(p["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * n:]         # (B,S,nheads)

    if cache is None:
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    else:
        # decode: conv over [history, x_t]
        hist = torch.cat([cache["conv"], xbc], dim=1)  # (B,width,C)
        out = hist[:, 0:1] * p["conv_w"][0]
        for i in range(1, width):
            out = out + hist[:, i:i + 1] * p["conv_w"][i]
        xbc = F.silu(out + p["conv_b"])
        cache["conv"].copy_(hist[:, 1:])

    xin = xbc[..., :d_inner].reshape(B_, S, nheads, hp)
    Bp = xbc[..., d_inner:d_inner + n]
    Cp = xbc[..., d_inner + n:]

    dt = _softplus(dt_raw.float() + p["dt_bias"])      # (B,S,h)
    A = -torch.exp(p["A_log"])                         # (h,)
    dA = dt * A                                        # (B,S,h)
    xbar = xin.float() * dt[..., None]

    if cache is None:
        y, _ = ssd_chunked(xbar, dA, Bp, Cp)
    else:
        # recurrent step: state <- exp(dA)*state + xbar (x) B ; y = C.state
        Bn, Cn = Bp[:, 0].float(), Cp[:, 0].float()    # (B,n)
        state = (torch.exp(dA[:, 0])[..., None, None] * cache["ssm"]
                 + torch.einsum("bhp,bn->bhpn", xbar[:, 0], Bn))
        y = torch.einsum("bhpn,bn->bhp", state, Cn)[:, None]  # (B,1,h,p)
        cache["ssm"].copy_(state)

    y = y + p["D"][:, None] * xin.float()
    y = y.reshape(B_, S, d_inner)
    y = y * F.silu(z.float())
    y = C.rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    return C.linear(p["out_proj"], y), cache
