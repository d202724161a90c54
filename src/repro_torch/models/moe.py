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

The reference's data-shard token grouping only acts under a device mesh
with a data axis, which this package does not have yet (ROADMAP queue 1
item 10b): ``no_data_grouping``, which the train step enters around its worker
``vmap`` as the reference's does, is a no-op until that grouping exists.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (dtype_of, init_linear, init_mlp,
                                       linear, mlp_block)

def no_data_grouping():
    """The reference's switch that turns the data-shard token grouping off
    for the code inside; without a mesh there is no grouping to turn off."""
    return contextlib.nullcontext()


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

    logits = linear(p["router"], xt.float())                  # (T,E) f32
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

    buf = torch.zeros((E, cap + 1, d), dtype=xt.dtype, device=dev)
    buf = buf.index_put((se, slot), xt[st], accumulate=True)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["moe_wg"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["moe_wi"])
    y = torch.einsum("ecf,efd->ecd", h, p["moe_wo"])          # (E,cap+1,d)

    # ---- gather back with router weights ----
    gathered = torch.where(keep[:, None], y[se, slot], 0.0)   # (T*k, d)
    w_sorted = gate.reshape(-1)[order]
    out = torch.zeros((T, d), dtype=y.dtype, device=dev).index_add(
        0, st, gathered * w_sorted[:, None].to(y.dtype))
    return out, aux


def moe_block(p, cfg, x: torch.Tensor):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    out, aux = _moe_ffn(p, cfg, xt)
    if "shared" in p:
        out = out + mlp_block(p["shared"], xt)
    return out.reshape(B, S, d), aux
