"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch,
shared experts, load-balance auxiliary loss.

Port of ``repro/models/moe.py``.  Dispatch is the reference's sort/segment
scheme (no (T, E, C) one-hot tensors): assignments are sorted by expert id
(a stable sort), each one's position within its expert comes from segment
offsets, tokens scatter into a dense (E, C + 1, d) buffer whose last slot
takes the overflow, two grouped products run the experts, and the results
gather back with the router weights.  Assignments past the capacity
C = int(ceil(T·k/E) · capacity_factor) + 1 are dropped.

Three choices keep the reference's semantics under ``torch.func``:
- top-k is a stable descending sort, so ties go to the lower expert index
  as ``lax.top_k``'s do (``torch.topk`` promises no order among ties);
- the per-expert counts come from ``scatter_add``: ``torch.bincount`` has
  no batching rule and would loop over the workers of a ``vmap``;
- the router is held and computed in f32 whatever the model's dtype.

On a mesh (``dist/mesh.py::use_mesh``) two things follow the reference:

- the data-shard token grouping: with a ``data`` axis of size g > 1 and
  T = B·S tokens in all, when T % g == 0 and T // g >= k the tokens are
  dispatched in g groups of T // g in (B, S) row-major order, capacity
  applying per group and the aux loss averaged; otherwise over the whole
  T.  On a world whose batch is sharded over the data axis a rank's rows
  are its group; the ungrouped branch gathers the tokens over the data
  axis, dispatches them whole and keeps this rank's rows.
  :func:`no_data_grouping`, which the train step enters as the
  reference's does, turns the grouping off;
- tensor-parallel experts: the f32 router is column-parallel and its
  logits are gathered before the top-k, so routing and capacity are the
  same on every model rank; ``moe_wi``/``moe_wg``/``moe_wo`` hold this
  rank's block of f, every rank dispatches the same tokens through its
  block, and the (T, d) output is summed over the model axes.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll
from repro_torch.dist.mesh import data_axis, data_axis_size
from repro_torch.models.common import (block_axes, col_linear, dtype_of,
                                       init_linear, init_mlp, is_block,
                                       mlp_block, model_copy)

_GROUPING = threading.local()


@contextlib.contextmanager
def no_data_grouping():
    """Turn the data-shard token grouping off for the code inside."""
    prev = getattr(_GROUPING, "off", False)
    _GROUPING.off = True
    try:
        yield
    finally:
        _GROUPING.off = prev


def grouping_enabled() -> bool:
    return not getattr(_GROUPING, "off", False)


def init_moe(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    dt = dtype_of(cfg)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = gen.device

    def experts(d_in, d_out):
        w = torch.randn(lead + (E, d_in, d_out), generator=gen, dtype=dt,
                        device=dev)
        return w.mul_(1.0 / math.sqrt(d_in))

    params = {
        "router": init_linear(gen, d, E, torch.float32, lead),
        "moe_wi": experts(d, f),
        "moe_wg": experts(d, f),
        "moe_wo": experts(f, d),
    }
    if cfg.num_shared_experts:
        params["shared"] = init_mlp(gen, cfg,
                                    d_ff=cfg.d_ff * cfg.num_shared_experts,
                                    lead=lead)
    return params


def _moe_ffn(p, cfg, xt: torch.Tensor):
    """Routed-expert FFN over a flat token group.  xt: (T, d) ->
    ((T, d), aux scalar)."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = xt.device

    xc = model_copy(xt)
    logits = col_linear(p["router"], xt.float(), xc.float(), E)  # (T,E) f32
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eids = srt.values[:, :k], srt.indices[:, :k]        # (T,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # ---- sort-based dispatch ----
    cap = int(-(-T * k // E) * cfg.capacity_factor) + 1       # C per expert
    flat_e = eids.reshape(-1)                                 # (T*k,)
    tok_of = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], tok_of[order]
    counts = torch.zeros((E,), dtype=torch.long, device=dev).scatter_add(
        0, se, torch.ones_like(se))                           # (E,)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e, with f_e the
    # fraction of assignments routed to e.
    me = probs.mean(dim=0)                                    # (E,)
    fe = counts.float() / (T * k)
    aux = cfg.router_aux_loss_coef * E * torch.sum(me * fe)

    starts = torch.cumsum(counts, 0) - counts                 # (E,)
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, pos, cap)                        # overflow slot

    sharded = is_block({"w": p["moe_wi"]}, cfg.d_ff)
    src = xc if sharded else xt
    buf = torch.zeros((E, cap + 1, d), dtype=xt.dtype, device=dev)
    buf = buf.index_put((se, slot), src[st], accumulate=True)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["moe_wg"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["moe_wi"])
    y = torch.einsum("ecf,efd->ecd", h, p["moe_wo"])          # (E,cap+1,d)

    # ---- gather back with router weights ----
    gathered = torch.where(keep[:, None], y[se, slot], 0.0)   # (T*k, d)
    w_sorted = gate.reshape(-1)[order]
    if sharded:                 # the replicated gates weigh partial outputs
        w_sorted = model_copy(w_sorted)
    out = torch.zeros((T, d), dtype=y.dtype, device=dev).index_add(
        0, st, gathered * w_sorted[:, None].to(y.dtype))
    if sharded:
        out = coll.reduce_from_model(out, block_axes())
    return out, aux


def moe_block(p, cfg, x: torch.Tensor, *, unread: bool = False):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar).  ``unread``: the
    shared experts' output is summed into an output that a residual add
    alone reads (``models/common.py::row_linear``)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    g = data_axis_size() if grouping_enabled() else 0
    dax = data_axis()                     # this rank's rows are a share
    T = B * S * (dax.size if dax is not None else 1)
    if g > 1 and T % g == 0 and T // g >= cfg.num_experts_per_tok:
        if dax is not None:               # this rank's rows: its group
            out, aux = _moe_ffn(p, cfg, xt)
            aux = coll.psum_axes(aux, (dax,)) / g
        else:
            n = T // g
            parts = [_moe_ffn(p, cfg, xt[i * n:(i + 1) * n])
                     for i in range(g)]
            out = torch.cat([o for o, _ in parts])
            aux = torch.stack([a for _, a in parts]).mean()
    elif g > 1 and dax is not None:
        # Dispatch over every rank's tokens (serving: no gradient crosses
        # this gather), and keep this rank's rows.
        n = B * S
        whole, aux = _moe_ffn(p, cfg, coll.all_gather_axes(xt, (dax,), 0))
        out = whole[dax.index * n:(dax.index + 1) * n]
    else:
        out, aux = _moe_ffn(p, cfg, xt)
    if "shared" in p:
        out = out + mlp_block(p["shared"], xt,
                              cfg.d_ff * cfg.num_shared_experts,
                              unread=unread)
    return out.reshape(B, S, d), aux
