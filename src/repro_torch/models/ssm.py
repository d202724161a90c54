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

from repro_torch.dist import collectives as coll
from repro_torch.dist.mesh import model_axes
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


def _heads(nheads: int):
    """(model axes, first head, end head) of this rank's SSD heads on a
    mesh whose model axes divide ``nheads``; (None, 0, nheads) elsewhere,
    where the block computes whole."""
    axes = model_axes()
    tp = coll.axis_size(axes)
    if tp == 1 or nheads % tp:
        return None, 0, nheads
    n = nheads // tp
    i = coll.worker_slice_index(axes)
    return axes, i * n, (i + 1) * n


def _whole(t: torch.Tensor, n: int) -> torch.Tensor:
    """A per-channel leaf of ``n`` channels (last dim) whole: a block that
    ``tree_pspecs`` cut (stacked layers' ``conv_w``/``conv_b``) gathered
    over the model axes."""
    if t.shape[-1] == n:
        return t
    return coll.gather_from_model(t, C.block_axes(), -1)


def _per_head(t: torch.Tensor, nheads: int, axes, h0: int, h1: int
              ) -> torch.Tensor:
    """This rank's heads of a per-head leaf (``dt_bias``, ``A_log``,
    ``D``): a block that ``tree_pspecs`` cut (stacked layers) holds
    exactly them; a whole leaf (a tail layer's) is sliced, through
    ``copy_to_model`` on a mesh, where every rank uses its part."""
    if t.shape[-1] != nheads or axes is None:
        return t
    return coll.copy_to_model(t, axes)[h0:h1]


def _mine(t: torch.Tensor, lo: int, hi: int, d_inner: int, axes
          ) -> torch.Tensor:
    """The conv channels (last dim) this rank uses of ``t``, which every
    model rank holds whole: its heads' x channels, then the shared B and
    C (``copy_to_model`` sums the ranks' gradients of the shared parts)."""
    t = coll.copy_to_model(t, axes)
    return torch.cat([t[..., lo:hi], t[..., d_inner:]], dim=-1)


def _gated_norm(p, y: torch.Tensor, eps: float, d_inner: int, axes
                ) -> torch.Tensor:
    """The gated RMSNorm over the whole ``d_inner`` of a ``y`` that holds
    this rank's heads: each token's sum of squares is summed over the
    model axes in f32, forward and backward (each rank's channels take
    part in every rank's normalizer)."""
    xf = y.float()
    ss = torch.sum(xf * xf, dim=-1, keepdim=True)
    ss = coll.copy_to_model(coll.reduce_from_model(ss, axes), axes)
    return (xf * torch.rsqrt(ss / d_inner + eps)
            * p["scale"].float()).to(y.dtype)


def mamba_block(p, cfg, x, *, cache: Optional[dict] = None,
                unread: bool = False):
    """Mamba2 block.  Training/prefill when cache is None; one decode step
    (S == 1) otherwise, which writes the conv history and the SSM state into
    ``cache`` in place.  Returns (out (B,S,d), cache).  ``unread``:
    ``out_proj``'s output is read by a residual add alone
    (``models/common.py::row_linear``).

    On a mesh whose model axes divide the heads, the block runs
    head-parallel: ``in_proj``'s column block (cut over the packed z | x |
    B | C | dt columns, not on head boundaries) is all_gathered, and each
    rank takes its heads' z, x and dt beside the shared B and C; the conv
    runs on those channels (``conv_w``'s block gathered the same way), the
    SSD scan, the ``D`` skip and the gate on this rank's heads, the gated
    norm with its sum of squares summed over the model axes, and the
    row-parallel ``out_proj`` on its ``d_inner/tp`` rows, exactly its
    heads.  The gathered projection, ``conv_w``, ``conv_b`` and the norm's
    ``scale`` (and a whole ``dt_bias``, ``A_log``, ``D``: a tail layer's,
    which ``tree_pspecs`` leaves whole at ndim 1; stacked layers' are cut
    to this rank's heads) are each used in part by every rank, so they go
    through ``copy_to_model`` (their gradients are the sums of the
    ranks').  The decode cache holds the whole conv history (every rank
    gathers every channel) and this rank's heads of the SSM state.
    Elsewhere (the heads do not divide) the block computes whole, the
    blocks of a cut leaf gathered."""
    B_, S, d = x.shape
    n, width = cfg.ssm_state, cfg.ssm_conv_width
    d_inner, nheads = _dims(cfg)
    hp = cfg.ssm_head_dim
    axes, h0, h1 = _heads(nheads)
    lo, hi = h0 * hp, h1 * hp

    zxbcdt = C.col_linear(p["in_proj"], x, C.model_copy(x),
                          2 * d_inner + 2 * n + nheads)
    conv_w, conv_b = (_whole(p[k], d_inner + 2 * n)
                      for k in ("conv_w", "conv_b"))
    if axes is not None:
        zxbcdt = coll.copy_to_model(zxbcdt, axes)
        conv_w = _mine(conv_w, lo, hi, d_inner, axes)
        conv_b = _mine(conv_b, lo, hi, d_inner, axes)
    z = zxbcdt[..., lo:hi]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * n:][..., h0:h1]   # (B,S,h)

    if cache is None:
        if axes is not None:
            xbc = torch.cat([xbc[..., lo:hi], xbc[..., d_inner:]], -1)
        xbc = _causal_conv(xbc, conv_w, conv_b)
    else:
        # decode: conv over [history, x_t]; the history stays whole
        hist = torch.cat([cache["conv"], xbc], dim=1)  # (B,width,C)
        cache["conv"].copy_(hist[:, 1:])
        if axes is not None:
            hist = torch.cat([hist[..., lo:hi], hist[..., d_inner:]], -1)
        out = hist[:, 0:1] * conv_w[0]
        for i in range(1, width):
            out = out + hist[:, i:i + 1] * conv_w[i]
        xbc = F.silu(out + conv_b)

    dl = hi - lo                                       # this rank's d_inner
    xin = xbc[..., :dl].reshape(B_, S, h1 - h0, hp)
    Bp = xbc[..., dl:dl + n]
    Cp = xbc[..., dl + n:]

    dt_bias, A_log, Dp = (_per_head(p[k], nheads, axes, h0, h1)
                          for k in ("dt_bias", "A_log", "D"))
    dt = _softplus(dt_raw.float() + dt_bias)           # (B,S,h)
    A = -torch.exp(A_log)                              # (h,)
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

    y = y + Dp[:, None] * xin.float()
    y = y.reshape(B_, S, dl)
    y = y * F.silu(z.float())
    if axes is None:
        y = C.rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
        return C.row_linear(p["out_proj"], y, d_inner,
                            unread=unread), cache
    scale = coll.copy_to_model(p["norm"]["scale"], axes)[lo:hi]
    y = _gated_norm({"scale": scale}, y.to(x.dtype), cfg.norm_eps, d_inner,
                    axes)
    # the model axes divide the heads, so tree_pspecs cut out_proj's
    # d_inner rows: its block is exactly this rank's heads
    return C.row_linear(p["out_proj"], y, d_inner, unread=unread), cache
