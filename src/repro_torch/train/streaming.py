"""Streaming (memory-bounded) robust aggregation.

Port of ``repro/train/streaming.py``.  The paper's rules need all m worker
gradients at once: O(m·|θ|) memory.  This mode computes the coordinate-wise
rules as streaming statistics over a sequential pass over the workers, one
worker's gradient at a time:

  Trmean_b = (Σ g_i − Σ bottom-b − Σ top-b) / (m − 2b)
     — a running sum plus the b smallest and b largest values seen per
       coordinate: O((2b+1)·|θ|);
  Phocas_b = (Σ g_i − Σ of the b values farthest from Trmean) / (m − b)
     — a second pass recomputes each worker's gradient and keeps the b
       (distance, value) pairs farthest from the trimmed mean.

Both are exact, not approximations.  No (m, |θ|) matrix is ever built: the
statistics are (b, *shape) per leaf, and the merges are torch sorts, as the
reference's are XLA sorts outside any Pallas kernel.

Per-worker attacks (``STREAMING_ATTACKS``) draw their noise from generators
seeded by the step's seed, the leaf and the worker, so the second pass
recomputes the identical corrupted gradient.  The bitflip attack reproduces a
quirk of the reference: it draws one victim per coordinate in [0, 20) and
flips the worker whose index ≡ victim (mod 20), whatever q and m are.
"""
from __future__ import annotations

import zlib
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.compress.pipeline import roundtrip_matrix
from repro_torch.compress.spec import make_codec
from repro_torch.core import registry
from repro_torch.core.attacks import AttackConfig, _flip_bits_f32, fold_seed
from repro_torch.core.robust import RobustConfig
from repro_torch.optim.optimizers import OptConfig, apply_updates

# Attacks computable one worker at a time (the scan never holds the worker
# matrix, so colluding adversaries, omniscient, innerprod and slowburn,
# cannot be simulated here).
STREAMING_ATTACKS = ("none", "gaussian", "signflip", "zero", "bitflip",
                     "gambler")

# Rules this module has a streaming formulation for; the registry's
# ``supports_streaming`` metadata names the same set.
STREAMING_IMPL_RULES = ("mean", "trmean", "phocas")


def _path_salt(path: str) -> int:
    """Stable 31-bit salt from a leaf's tree path (``"fc1/w"``); CRC32, not
    ``hash``, which is salted per process."""
    return zlib.crc32(path.encode("utf-8")) & 0x7FFFFFFF


def _leaf_paths(tree, prefix="") -> list:
    """The ``/``-joined path of every leaf, in ``tree.leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _worker_attack(cfg: AttackConfig, g, widx: int, seed: int):
    """Apply a per-worker-computable attack to worker ``widx``'s gradient
    tree (the streaming analogue of ``core.attacks`` on the (m, d)
    matrix)."""
    name = cfg.name.lower()
    q = cfg.num_byzantine
    leaves = tree_util.leaves(g)
    if name in ("none", ""):
        return g
    if name in ("gaussian", "signflip", "zero") and widx >= q:
        return g
    if name == "gaussian":
        # Salted by leaf path AND worker: q independent noise rows.
        out = [cfg.gaussian_std * torch.randn(
            x.shape, dtype=torch.float32, device=x.device,
            generator=_gen(fold_seed(fold_seed(seed, _path_salt(p)), widx),
                           x.device)).to(x.dtype)
            for p, x in zip(_leaf_paths(g), leaves)]
    elif name == "signflip":
        out = [-10.0 * x for x in leaves]
    elif name == "zero":
        out = [torch.zeros_like(x) for x in leaves]
    elif name == "bitflip":
        # one victim per coordinate, drawn alike for every worker
        out = []
        for i, x in enumerate(leaves):
            victim = torch.randint(0, 20, x.shape, device=x.device,
                                   generator=_gen(fold_seed(seed, i),
                                                  x.device))
            flipped = _flip_bits_f32(x.float(), cfg.bitflip_bits)
            out.append(torch.where(victim == widx % 20, flipped,
                                   x.float()).to(x.dtype))
    elif name == "gambler":
        out = []
        for i, x in enumerate(leaves):
            hit = torch.rand(x.shape, device=x.device, generator=_gen(
                fold_seed(seed, 7919 + i), x.device)) < cfg.gambler_prob
            out.append(torch.where(hit, cfg.gambler_scale * x, x))
    else:
        raise ValueError(
            f"attack {cfg.name!r} not supported in streaming mode "
            f"(supported: {STREAMING_ATTACKS}; omniscient/innerprod/"
            "slowburn need all worker gradients at once)")
    return tree_util.unflatten(g, out)


def _merge_bottom(bot: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """bot: (b, *s) smallest so far; returns the updated (b, *s)."""
    return torch.sort(torch.cat([bot, g[None]]), dim=0).values[:-1]


def _merge_top(top: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.sort(torch.cat([top, g[None]]), dim=0).values[1:]


def _merge_top_by_dist(dtop, vtop, d, v):
    """Keep the b (distance, value) pairs with the largest distance; the
    sort is stable, as ``jnp.argsort``, so equal distances keep the earlier
    worker's pair in front."""
    dc = torch.cat([dtop, d[None]])
    vc = torch.cat([vtop, v[None]])
    order = torch.argsort(dc, dim=0, stable=True)[1:]     # drop smallest
    return (torch.take_along_dim(dc, order, dim=0),
            torch.take_along_dim(vc, order, dim=0))


def make_streaming_train_step(model, *, robust_cfg: RobustConfig,
                              opt_cfg: OptConfig, num_workers: int,
                              compress_cfg=None):
    """Streaming-mode train step ``step(params, opt_state, batch, seed) ->
    (params, opt_state, metrics)``: batch leaves (m, B/m, ...) are visited
    one worker at a time; ``seed`` (an int) seeds the step's attack noise
    and codec rounding.

    ``compress_cfg`` routes each worker's gradient through a stateless
    codec round trip (the server's statistics see the dequantized
    gradient); stateful codecs are refused, since an (m, |θ|) residual
    breaks the memory contract.
    """
    m = num_workers
    codec = make_codec(compress_cfg)
    if codec is not None and codec.stateful:
        raise ValueError(
            f"codec {codec.name!r} carries error-feedback state; streaming "
            "mode supports stateless codecs only (see repro_torch.compress)")
    b = robust_cfg.b
    rule = robust_cfg.rule
    if not registry.get_rule(rule).supports_streaming:
        raise ValueError(
            f"streaming mode supports {registry.streaming_rules()}, got "
            f"{rule!r} (rules opt in via supports_streaming=True)")
    if not 0 <= b <= (m + 1) // 2 - 1:
        raise ValueError(f"b={b} out of range for m={m}")
    grad_and_loss = torch.func.grad_and_value(model.loss)

    def worker_grad(params, batch, widx, seed):
        sub = {k: v[widx] for k, v in batch.items()}
        g, loss = grad_and_loss(params, sub)
        g = _worker_attack(robust_cfg.attack,
                           tree_util.map(lambda x: x.float(), g), widx, seed)
        if codec is not None:
            # wire round trip: malicious gradients are honestly encoded
            leaves = tree_util.leaves(g)
            row = torch.cat([x.reshape(1, -1) for x in leaves], dim=1)
            row = roundtrip_matrix(row, codec, _gen(fold_seed(seed, widx),
                                                    row.device))[0]
            parts = torch.split(row.float(), [x.numel() for x in leaves])
            g = tree_util.unflatten(g, [p.reshape(x.shape)
                                        for p, x in zip(parts, leaves)])
        return g, loss

    def step(params, opt_state, batch, seed: int):
        ssum = tree_util.map(lambda p: torch.zeros_like(p.float()), params)
        bot = tree_util.map(lambda p: torch.full(
            (b,) + tuple(p.shape), torch.inf, device=p.device), params)
        top = tree_util.map(lambda x: -x, bot)
        losses = []
        for widx in range(m):
            g, loss = worker_grad(params, batch, widx, seed)
            ssum = tree_util.map(torch.add, ssum, g)
            if b:
                bot = tree_util.map(_merge_bottom, bot, g)
                top = tree_util.map(_merge_top, top, g)
            losses.append(loss)
        losses = torch.stack(losses)

        metrics = {"loss": losses.mean(), "loss_per_worker": losses}
        if rule == "mean" or b == 0:
            agg = tree_util.map(lambda s: s / m, ssum)
        else:
            center = tree_util.map(
                lambda s, lo, hi: (s - lo.sum(0) - hi.sum(0)) / (m - 2 * b),
                ssum, bot, top)
            del bot, top
            if rule == "trmean":
                agg = center
            else:                                   # phocas: second pass
                from repro_torch.defense.scores import distance_ratio_scores
                dtop = tree_util.map(lambda p: torch.full(
                    (b,) + tuple(p.shape), -torch.inf, device=p.device),
                    params)
                vtop = tree_util.map(lambda x: torch.zeros_like(x), dtop)
                masses = []
                for widx in range(m):
                    g, _ = worker_grad(params, batch, widx, seed)
                    d = tree_util.map(lambda x, c: (x - c).abs(), g, center)
                    # O(1)-memory suspicion: total L1 distance from the
                    # robust center
                    masses.append(sum(x.sum() for x in tree_util.leaves(d)))
                    merged = [_merge_top_by_dist(*t) for t in zip(
                        tree_util.leaves(dtop), tree_util.leaves(vtop),
                        tree_util.leaves(d), tree_util.leaves(g))]
                    dtop = tree_util.unflatten(dtop, [t[0] for t in merged])
                    vtop = tree_util.unflatten(vtop, [t[1] for t in merged])
                metrics["suspicion"] = distance_ratio_scores(
                    torch.stack(masses))
                agg = tree_util.map(lambda s, v: (s - v.sum(0)) / (m - b),
                                    ssum, vtop)

        agg = tree_util.map(lambda a, p: a.to(p.dtype), agg, params)
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        return params, opt_state, metrics

    return step


def run_streaming_training(model, batch_fn: Callable[[int], dict],
                           robust_cfg: RobustConfig, opt_cfg: OptConfig,
                           *, num_workers: int, steps: int, seed: int = 0,
                           eval_fn: Optional[Callable] = None,
                           telemetry_path: Optional[str] = None,
                           device=None) -> list:
    """Deprecated legacy shim: delegates to the ``streaming`` topology and
    returns the history records.  New code builds a ``ScenarioSpec`` with
    ``topology="streaming"`` and calls ``run_experiment``."""
    from repro_torch.experiment.runner import plan_from_parts
    from repro_torch.experiment.topology import make_topology
    plan = plan_from_parts(
        model=model, batch_fn=batch_fn, robust_cfg=robust_cfg,
        opt_cfg=opt_cfg, num_workers=num_workers, steps=steps, seed=seed,
        topology="streaming", eval_fn=eval_fn, record_every=10,
        telemetry_path=telemetry_path, device=device)
    return make_topology("streaming").run(plan).history
