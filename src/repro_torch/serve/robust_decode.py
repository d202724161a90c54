"""Replicated Byzantine-robust decode (port of
``repro/serve/robust_decode.py``, DESIGN.md §11).

The serving analogue of the paper's dimensional trimmed-mean guarantee: run
``k`` model replicas per decode step and aggregate their per-token logits
coordinate-wise through any registered rule, so a corrupted replica cannot
steer generation.  The rule's per-replica suspicion scores feed the defense
loop's EMA reputation (``defense/reputation.py``), so a persistently
corrupted replica is ejected from the aggregate (its rows replaced by the
replica median through the gate).

The logits (k, B, V) are flattened to (k, B·V): each vocabulary coordinate of
each request is one aggregation coordinate, the worker-gradient layout the
rules and their kernels already take.  With phocas on the kernel backend a
decode step runs the counts kernel (scores) and, once a replica is ejected,
the aggregate kernel on the gated matrix.

With two identical honest replicas among k=3 and b=1, trmean/phocas return
the honest logit exactly per coordinate, so robust greedy decode equals
clean greedy decode token for token.  That needs the honest replicas to
share their parameter tensors (``make_replicas`` does not clone) and every
step to be deterministic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.defense.reputation import (DefenseConfig, init_reputation,
                                            update_reputation)


def make_replicas(params, k: int, *, gen: Optional[torch.Generator] = None,
                  jitter: float = 0.0) -> tuple:
    """``k`` replicas of a params tree, as a TUPLE of trees.

    ``jitter = 0`` gives the same tree ``k`` times — shared tensors, no
    copy — the fault-tolerance configuration whose robust aggregate is
    exactly the clean value.  ``jitter > 0`` adds independent Gaussian
    perturbations of that relative scale per replica, drawn from ``gen``.
    """
    if jitter <= 0.0:
        return tuple(params for _ in range(k))
    if gen is None:
        raise ValueError("jitter > 0 needs an explicit torch.Generator")

    def noised(x):
        noise = torch.randn(x.shape, generator=gen, dtype=torch.float32,
                            device=x.device).to(x.dtype)
        return x + jitter * torch.std(x) * noise

    return tuple(tree_util.map(noised, params) for _ in range(k))


def corrupt_replica(replicas: tuple, index: int, gen: torch.Generator,
                    scale: float = 20.0) -> tuple:
    """Replace replica ``index``'s parameters with large Gaussian noise (the
    garbage-logits fault), drawn from ``gen`` in each parameter's dtype."""
    garbage = tree_util.map(
        lambda x: torch.randn(x.shape, generator=gen, dtype=x.dtype,
                              device=x.device).mul_(scale),
        replicas[index])
    return tuple(garbage if i == index else r
                 for i, r in enumerate(replicas))


class RobustDecoder:
    """Aggregation + reputation policy for k-replica decode.

    Owns the rule instance and the reputation state (tensors on
    ``device``); :meth:`aggregate` is the per-step math, :meth:`observe`
    adopts its result on the host side.
    """

    def __init__(self, rule: str = "phocas", k: int = 3,
                 b: Optional[int] = None,
                 defense: Optional[DefenseConfig] = None,
                 backend: str = "auto", device=None):
        if k < 2:
            raise ValueError(f"replicated decode needs k >= 2, got {k}")
        bmax = (k + 1) // 2 - 1
        self.b = bmax if b is None else b
        if not 0 <= self.b <= bmax:
            raise ValueError(f"need 0 <= b <= (k+1)//2-1 = {bmax} for k={k} "
                             f"replicas, got b={self.b}")
        self.k = k
        self.rule_name = rule
        self.backend = backend
        self.rule = make_rule(rule, RuleParams(b=self.b, q=self.b,
                                               backend=backend))
        self.defense = defense or DefenseConfig()
        self.rep_state = init_reputation(k, device=device)

    def shrink(self, index: int) -> None:
        """Drop replica ``index`` after a crash: k shrinks by one, b
        re-resolves against the survivors, the rule is rebuilt, and the
        dead replica's reputation row is removed."""
        if self.k <= 2:
            raise ValueError(
                f"cannot shrink below k=2 (robust decode needs a pair to "
                f"compare); k={self.k}")
        if not 0 <= index < self.k:
            raise ValueError(f"replica index {index} out of range for "
                             f"k={self.k}")
        keep = [i for i in range(self.k) if i != index]
        self.k -= 1
        self.b = min(self.b, (self.k + 1) // 2 - 1)
        self.rule = make_rule(self.rule_name,
                              RuleParams(b=self.b, q=self.b,
                                         backend=self.backend))
        self.rep_state = {
            k: (v[keep] if v.dim() == 1 else v)
            for k, v in self.rep_state.items()}

    def aggregate(self, logits: torch.Tensor, rep_state: dict
                  ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        """(k, B, V) per-replica logits -> ((B, V) aggregate, (k,) scores,
        updated reputation state).  Scores observe the raw matrix; the
        aggregate reads the reputation-gated matrix."""
        k, B, V = logits.shape
        mat = logits.reshape(k, B * V).float()
        agg, scores = self.rule.reduce_gated_with_scores(
            mat, rep_state["active"])
        new_state = update_reputation(rep_state, scores, self.defense)
        return agg.reshape(B, V), scores, new_state

    def observe(self, new_state: dict, scores, telemetry=None,
                step: int = 0) -> None:
        """Adopt the post-step reputation state; mirror it to the bus
        (per-step JSONL record + ejection/readmission counters on the
        active-mask transition)."""
        from repro_torch.obs.metrics import as_recorder
        rec = as_recorder(telemetry)
        if rec.metrics_enabled:
            old = self.rep_state["active"].tolist()
            new = new_state["active"].tolist()
            ej = sum(1 for a, b in zip(old, new) if a != 0 and b == 0)
            readmit = sum(1 for a, b in zip(old, new) if a == 0 and b != 0)
            if ej:
                rec.count("ejections", ej, stream="robust_decode")
            if readmit:
                rec.count("readmissions", readmit, stream="robust_decode")
        self.rep_state = new_state
        rec.log("robust_decode", step,
                rule=self.rule_name, k=self.k, b=self.b,
                scores=scores,
                reputation=new_state["reputation"],
                active=new_state["active"])

    @property
    def active(self):
        return self.rep_state["active"]

    def ejected_replicas(self) -> list:
        return [i for i, a in enumerate(self.rep_state["active"].tolist())
                if a == 0.0]
