"""Optimizers as functions over parameter trees (no torch.optim state).

Port of ``repro/optim/optimizers.py``: plain SGD (the paper's), momentum,
Adam and AdamW, with optional global-norm gradient clipping.  The robust
rule replaces the gradient estimate; everything downstream is standard.
``state["step"]`` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch import tree as tree_util

Schedule = Union[float, Callable[[int], float]]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "sgd"                 # sgd | momentum | adam | adamw
    lr: Schedule = 0.1                # paper default for MNIST MLP
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0            # 0 = off

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)


def init_opt_state(cfg: OptConfig, params) -> dict:
    zeros = lambda: tree_util.map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    state = {"step": 0}
    if cfg.name == "momentum":
        state["mu"] = zeros()
    elif cfg.name in ("adam", "adamw"):
        state["mu"] = zeros()
        state["nu"] = zeros()
    elif cfg.name != "sgd":
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return state


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of a tree of tensors, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_util.leaves(tree)))


def _clip(cfg: OptConfig, grads, norm):
    if not cfg.grad_clip:
        return grads
    scale = torch.clamp(cfg.grad_clip / torch.clamp(norm(grads),
                                                    min=1e-12), max=1.0)
    return tree_util.map(lambda g: g * scale.to(g.dtype), grads)


def apply_updates(cfg: OptConfig, params, grads, state, norm=tree_norm):
    """Returns (new_params, new_state); inputs are not modified.  ``norm``
    is the gradient tree's global norm for clipping (a mesh step's trees
    are this rank's blocks)."""
    step = state["step"] + 1
    lr = cfg.lr_at(step)
    grads = _clip(cfg, grads, norm)

    if cfg.name == "sgd":
        upd = grads                 # made f32 leaf by leaf in upd_leaf
        new_state = {"step": step}
    elif cfg.name == "momentum":
        mu = tree_util.map(lambda m, g: cfg.momentum * m + g.float(),
                           state["mu"], grads)
        upd = mu
        new_state = {"step": step, "mu": mu}
    else:                                           # adam / adamw
        mu = tree_util.map(
            lambda m, g: cfg.beta1 * m + (1 - cfg.beta1) * g.float(),
            state["mu"], grads)
        nu = tree_util.map(
            lambda v, g: cfg.beta2 * v
            + (1 - cfg.beta2) * torch.square(g.float()),
            state["nu"], grads)
        bc1 = 1 - cfg.beta1 ** step
        bc2 = 1 - cfg.beta2 ** step
        upd = tree_util.map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps), mu, nu)
        new_state = {"step": step, "mu": mu, "nu": nu}

    def upd_leaf(p, u):
        u = u.float() * lr
        if cfg.name == "adamw" and cfg.weight_decay and p.dim() >= 2:
            u = u + lr * cfg.weight_decay * p.float()
        return (p.float() - u).to(p.dtype)

    return tree_util.map(upd_leaf, params, upd), new_state
