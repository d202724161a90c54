"""Generic decoder-only stack, the GQA subset of ``repro/models/stack.py``.

The parameter layout is the reference's: ``blocks.l{j}.*`` holds the j-th
layer of every window-pattern period, stacked on a leading period axis, and
``tail{j}`` the remainder layers.  The reference's ``lax.scan`` over periods
is a Python loop over period index views here (a view, so the caches the
loop writes in place are the stacked tensors themselves).  Windows and
post-norms are covered; MoE, MLA, SSM and hybrid layers raise
``NotImplementedError`` (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util
from repro_torch.models import common as C


def check_ported(cfg) -> None:
    """Refuse the layer kinds this package does not build yet."""
    from repro_torch.experiment.spec import not_ported
    for flag, what in ((cfg.is_moe, "MoE layers"), (cfg.use_mla, "MLA"),
                       (cfg.is_ssm, "SSM layers"),
                       (cfg.hybrid, "hybrid attention+SSM layers")):
        if flag:
            raise not_ported(f"{what} (arch {cfg.name!r})", "item 11")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen, cfg, lead: tuple = ()) -> dict:
    check_ported(cfg)
    dt = C.dtype_of(cfg)
    d, dev = cfg.d_model, gen.device
    p = {"ln1": C.init_norm(d, dt, lead, dev),
         "mixer": C.init_attention(gen, cfg, lead),
         "ln2": C.init_norm(d, dt, lead, dev),
         "ffn": C.init_mlp(gen, cfg, lead=lead)}
    if cfg.use_post_norms:
        p["post_ln1"] = C.init_norm(d, dt, lead, dev)
        p["post_ln2"] = C.init_norm(d, dt, lead, dev)
    return p


def _ffn(p, cfg, x):
    h = C.rmsnorm(p["ln2"], x, cfg.norm_eps)
    f = C.mlp_block(p["ffn"], h)
    if cfg.use_post_norms:
        f = C.rmsnorm(p["post_ln2"], f, cfg.norm_eps)
    return x + f


def layer_fwd(p, cfg, x, *, window, positions, cache=None):
    """Returns (x, cache, aux); the cache is updated in place."""
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix, nc = C.attention_block(p["mixer"], cfg, h, positions=positions,
                                window=window,
                                cache=None if cache is None
                                else cache["mixer"])
    if cfg.use_post_norms:
        mix = C.rmsnorm(p["post_ln1"], mix, cfg.norm_eps)
    new_cache = None if cache is None else {"mixer": nc}
    aux = torch.zeros((), device=x.device)     # MoE's aux loss: none here
    return _ffn(p, cfg, x + mix), new_cache, aux


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
        f"l{j}": {"mixer": C.init_attn_cache(cfg, batch, max_len, windows[j],
                                             (n_periods,), device)}
        for j in range(P)}}
    for j in range(tail):
        cache[f"tail{j}"] = {"mixer": C.init_attn_cache(
            cfg, batch, max_len, windows[n_periods * P + j], (), device)}
    return cache


def stack_fwd(params, cfg, x, *, positions, cache=None, remat: str = "none"):
    """Apply the full layer stack.  Returns (x, cache, aux_total); the cache
    is updated in place."""
    if remat != "none":
        from repro_torch.experiment.spec import not_ported
        raise not_ported(f"activation remat {remat!r} (LM training)",
                         "item 11")
    windows, P, n_periods, tail = _period_geometry(cfg)
    aux = torch.zeros((), device=x.device)
    for i in range(n_periods):
        blk_p = _period(params["blocks"], i)
        blk_c = None if cache is None else _period(cache["blocks"], i)
        for j in range(P):
            x, _, a = layer_fwd(blk_p[f"l{j}"], cfg, x, window=windows[j],
                                positions=positions,
                                cache=None if blk_c is None
                                else blk_c[f"l{j}"])
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
    return _ffn(p, cfg, x + mix), {"mixer": nc}


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
