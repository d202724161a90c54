"""Generic decoder-only stack, a port of ``repro/models/stack.py``.

The parameter layout is the reference's: ``blocks.l{j}.*`` holds the j-th
layer of every window-pattern period, stacked on a leading period axis, and
``tail{j}`` the remainder layers.  The reference's ``lax.scan`` over periods
is a Python loop over period index views here (a view, so the caches the
loop writes in place are the stacked tensors themselves).  Mixers are GQA
(with windows and post-norms), MLA, the Mamba2 SSD block (an SSM layer *is*
its block: no FFN) or hymba's hybrid of attention and SSD on the same
input; FFNs are dense GLU or MoE.

``remat`` ("none" | "full" | "dots") recomputes each period in the backward
pass, as the reference's ``jax.checkpoint`` of its scan body does.
``torch.utils.checkpoint`` does not run under ``torch.func.grad`` (it needs
saved-tensor hooks), so a period is a ``torch.autograd.Function``
(:class:`_RematPeriod`, also used through :func:`checkpointed` by the
enc-dec layers) whose backward recomputes it through
``torch.func.vjp``; ``generate_vmap_rule`` lets the worker ``vmap`` of the
train step batch it.  "full" keeps only the period's input; "dots" also
keeps the output of every ``linear`` product, the products without batch
dimensions that ``dots_with_no_batch_dims_saveable`` saves, and recomputes
the rest (``models/common.py::record_dots``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree as tree_util
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

REMAT_MODES = ("none", "full", "dots")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen, cfg, lead: tuple = ()) -> dict:
    dt = C.dtype_of(cfg)
    d, dev = cfg.d_model, gen.device
    p = {"ln1": C.init_norm(d, dt, lead, dev)}
    if cfg.is_ssm:
        p["mixer"] = S.init_mamba(gen, cfg, lead)
        return p                                  # mamba2: block IS the layer
    if cfg.hybrid:
        p["mixer"] = C.init_attention(gen, cfg, lead)
        p["mixer_ssm"] = S.init_mamba(gen, cfg, lead)
        p["branch_norm_a"] = C.init_norm(d, dt, lead, dev)
        p["branch_norm_s"] = C.init_norm(d, dt, lead, dev)
    else:
        mixer = C.init_mla if cfg.use_mla else C.init_attention
        p["mixer"] = mixer(gen, cfg, lead)
    p["ln2"] = C.init_norm(d, dt, lead, dev)
    p["ffn"] = (M.init_moe(gen, cfg, lead) if cfg.is_moe
                else C.init_mlp(gen, cfg, lead=lead))
    if cfg.use_post_norms:
        p["post_ln1"] = C.init_norm(d, dt, lead, dev)
        p["post_ln2"] = C.init_norm(d, dt, lead, dev)
    return p


def init_layer_cache(cfg, batch: int, max_len: int, window, lead: tuple = (),
                     device=None) -> dict:
    if cfg.is_ssm:
        return {"mixer": S.init_mamba_cache(cfg, batch, lead, device)}
    if cfg.use_mla:
        return {"mixer": C.init_mla_cache(cfg, batch, max_len, lead, device)}
    cache = {"mixer": C.init_attn_cache(cfg, batch, max_len, window, lead,
                                        device)}
    if cfg.hybrid:
        cache["mixer_ssm"] = S.init_mamba_cache(cfg, batch, lead, device)
    return cache


def _ffn(p, cfg, x):
    """The FFN half of a layer; returns (x, aux)."""
    h = C.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        f, aux = M.moe_block(p["ffn"], cfg, h)
    else:
        f, aux = C.mlp_block(p["ffn"], h), torch.zeros((), device=x.device)
    if cfg.use_post_norms:
        f = C.rmsnorm(p["post_ln2"], f, cfg.norm_eps)
    return x + f, aux


def layer_fwd(p, cfg, x, *, window, positions, cache=None):
    """Returns (x, cache, aux); the cache is updated in place."""
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    c = cache or {}
    if cfg.is_ssm:
        mix, _ = S.mamba_block(p["mixer"], cfg, h, cache=c.get("mixer"))
        return x + mix, cache, torch.zeros((), device=x.device)
    if cfg.hybrid:
        attn, _ = C.attention_block(p["mixer"], cfg, h, positions=positions,
                                    window=window, cache=c.get("mixer"))
        ssm, _ = S.mamba_block(p["mixer_ssm"], cfg, h,
                               cache=c.get("mixer_ssm"))
        mix = 0.5 * (C.rmsnorm(p["branch_norm_a"], attn, cfg.norm_eps)
                     + C.rmsnorm(p["branch_norm_s"], ssm, cfg.norm_eps))
    elif cfg.use_mla:
        mix, _ = C.mla_block(p["mixer"], cfg, h, positions=positions,
                             cache=c.get("mixer"))
    else:
        mix, _ = C.attention_block(p["mixer"], cfg, h, positions=positions,
                                   window=window, cache=c.get("mixer"))
    if cfg.use_post_norms:
        mix = C.rmsnorm(p["post_ln1"], mix, cfg.norm_eps)
    x, aux = _ffn(p, cfg, x + mix)
    return x, cache, aux


# ---------------------------------------------------------------------------
# Stack: periods + tail
# ---------------------------------------------------------------------------

def _period_geometry(cfg):
    windows = cfg.layer_windows()
    P = max(len(cfg.window_pattern), 1)
    n_periods, tail = divmod(cfg.num_layers, P)
    return windows, P, n_periods, tail


def _period(tree, i: int):
    """Period ``i`` of a stacked tree, as views."""
    return tree_util.map(lambda x: x[i], tree)


def init_stack(gen, cfg) -> dict:
    windows, P, n_periods, tail = _period_geometry(cfg)
    params = {"blocks": {f"l{j}": init_layer(gen, cfg, (n_periods,))
                         for j in range(P)}}
    for j in range(tail):
        params[f"tail{j}"] = init_layer(gen, cfg)
    return params


def init_stack_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    windows, P, n_periods, tail = _period_geometry(cfg)
    cache = {"blocks": {
        f"l{j}": init_layer_cache(cfg, batch, max_len, windows[j],
                                  (n_periods,), device)
        for j in range(P)}}
    for j in range(tail):
        cache[f"tail{j}"] = init_layer_cache(
            cfg, batch, max_len, windows[n_periods * P + j], (), device)
    return cache


class _RematPeriod(torch.autograd.Function):
    """One period, recomputed in the backward pass.  ``fn(x, *leaves) ->
    (x, aux)`` is the period over its input and its parameter leaves;
    with ``dots`` the forward also returns the outputs of its ``linear``
    products, which the backward's recompute replays."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, dots, x, *leaves):
        if not dots:
            return fn(x, *leaves)
        with C.record_dots() as tape:
            y, aux = fn(x, *leaves)
        return (y, aux, *tape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, dots, x, *leaves = inputs
        kept = tuple(output[2:])
        ctx.fn, ctx.dots, ctx.n = fn, dots, len(leaves)
        ctx.save_for_backward(x, *leaves, *kept)
        if kept:
            ctx.mark_non_differentiable(*kept)

    @staticmethod
    def backward(ctx, gy, gaux, *_):
        saved = ctx.saved_tensors
        x, leaves = saved[0], saved[1:1 + ctx.n]
        replay = (C.replay_dots(saved[1 + ctx.n:]) if ctx.dots
                  else contextlib.nullcontext())
        with replay:
            _, vjp = torch.func.vjp(ctx.fn, x, *leaves)
            grads = vjp((gy, gaux))
        # ``torch.func.grad`` runs its backward with create_graph=True, so
        # the caller's level records the recompute and its vjp, and the
        # gradients would hold that graph, every period's activations,
        # until the whole backward ends.  Detached, a period's graph goes
        # as soon as its gradients are out (there is no double backward
        # through a recomputed period).  The same kernels run as without
        # remat: grad mode, which steers some of them, is left as it is.
        return (None, None, *(g.detach() for g in grads))


def checkpointed(fn, x, *leaves, dots: bool = False):
    """``fn(x, *leaves) -> (y, aux)`` with its activations recomputed in
    the backward pass ("dots": but for its ``linear`` outputs).  ``fn``
    must capture no tensor: everything it differentiates comes in as an
    argument."""
    y, aux, *_ = _RematPeriod.apply(fn, dots, x, *leaves)
    return y, aux


def _run_period(blk_p, cfg, x, windows, remat):
    """Apply one period's layers to a cacheless (training) input at
    positions 0..S-1; returns (x, aux).  ``period`` captures no tensor (a
    ``torch.autograd.Function`` under ``vmap`` must not): the positions are
    made inside it."""
    P = len(blk_p)

    def period(x, *leaves):
        p = tree_util.unflatten(blk_p, list(leaves))
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)
        for j in range(P):
            x, _, a = layer_fwd(p[f"l{j}"], cfg, x, window=windows[j],
                                positions=positions)
            aux = aux + a
        return x, aux

    leaves = tree_util.leaves(blk_p)
    if remat == "none":
        return period(x, *leaves)
    return checkpointed(period, x, *leaves, dots=remat == "dots")


def stack_fwd(params, cfg, x, *, positions, cache=None, remat: str = "none"):
    """Apply the full layer stack.  Returns (x, cache, aux_total); the cache
    is updated in place.  ``remat`` applies to the periods of a cacheless
    (training) call, as the reference's checkpointed scan body."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r}; valid: {REMAT_MODES}")
    windows, P, n_periods, tail = _period_geometry(cfg)
    aux = torch.zeros((), device=x.device)
    for i in range(n_periods):
        blk_p = _period(params["blocks"], i)
        if cache is None:
            x, a = _run_period(blk_p, cfg, x, windows, remat)
            aux = aux + a
            continue
        blk_c = _period(cache["blocks"], i)
        for j in range(P):
            x, _, a = layer_fwd(blk_p[f"l{j}"], cfg, x, window=windows[j],
                                positions=positions, cache=blk_c[f"l{j}"])
            aux = aux + a
    for j in range(tail):
        x, _, a = layer_fwd(params[f"tail{j}"], cfg, x,
                            window=windows[n_periods * P + j],
                            positions=positions,
                            cache=None if cache is None
                            else cache[f"tail{j}"])
        aux = aux + a
    return x, cache, aux


# ---------------------------------------------------------------------------
# Paged-cache variant (DESIGN.md §11)
# ---------------------------------------------------------------------------

def paged_supported(cfg) -> bool:
    """Whether the paged serving path covers this architecture: plain global
    GQA decoder stacks only.  SSM/hybrid state is not paged, MLA caches
    latents (different pool shape), enc-dec has a second stream, and windowed
    ring buffers contradict the grow-only block table."""
    return (not (cfg.is_ssm or cfg.hybrid or cfg.use_mla or cfg.is_encdec)
            and all(w is None for w in cfg.layer_windows()))


def init_stack_paged_cache(cfg, num_blocks: int, block_tokens: int,
                           device=None) -> dict:
    """Per-layer block pools with the same period-grouped structure as
    :func:`init_stack_cache`."""
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"paged KV cache unsupported for arch {cfg.name!r}: requires a "
            "plain global-attention decoder (no SSM/hybrid/MLA/enc-dec, no "
            "sliding windows); use init_stack_cache / the dense engine")
    windows, P, n_periods, tail = _period_geometry(cfg)
    cache = {"blocks": {
        f"l{j}": {"mixer": C.init_paged_kv(cfg, num_blocks, block_tokens,
                                           (n_periods,), device)}
        for j in range(P)}}
    for j in range(tail):
        cache[f"tail{j}"] = {"mixer": C.init_paged_kv(
            cfg, num_blocks, block_tokens, (), device)}
    return cache


def layer_fwd_paged(p, cfg, x, *, positions, block_tables, cache,
                    prefill=False):
    """Returns (x, cache); the layer's block pool is written in place."""
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn = (C.attention_block_prefill_paged if prefill
            else C.attention_block_paged)
    mix, nc = attn(p["mixer"], cfg, h, positions=positions,
                   block_tables=block_tables, cache=cache["mixer"])
    if cfg.use_post_norms:
        mix = C.rmsnorm(p["post_ln1"], mix, cfg.norm_eps)
    x, _ = _ffn(p, cfg, x + mix)       # MoE's aux is dropped at inference
    return x, {"mixer": nc}


def stack_fwd_paged(params, cfg, x, *, positions, block_tables, cache,
                    prefill=False):
    """Paged analogue of :func:`stack_fwd` (cache always present).
    Returns (x, cache)."""
    windows, P, n_periods, tail = _period_geometry(cfg)
    for i in range(n_periods):
        blk_p = _period(params["blocks"], i)
        blk_c = _period(cache["blocks"], i)
        for j in range(P):
            x, _ = layer_fwd_paged(blk_p[f"l{j}"], cfg, x,
                                   positions=positions,
                                   block_tables=block_tables,
                                   cache=blk_c[f"l{j}"], prefill=prefill)
    for j in range(tail):
        x, _ = layer_fwd_paged(params[f"tail{j}"], cfg, x,
                               positions=positions,
                               block_tables=block_tables,
                               cache=cache[f"tail{j}"], prefill=prefill)
    return x, cache
