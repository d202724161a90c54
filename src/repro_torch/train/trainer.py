"""Deprecated sync-PS legacy shim.

Port of ``repro/train/trainer.py``.  ``Trainer`` predates the declarative
experiment API; the loop it used to own lives in the ``sync_ps`` topology
(``repro_torch.experiment.topologies.SyncPS``), and this class is a thin
delegation kept so call sites and checkpoints written through it keep
working.  New code builds a ``repro_torch.experiment.ScenarioSpec`` and
calls ``run_experiment``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.robust import RobustConfig
from repro_torch.optim.optimizers import OptConfig, init_opt_state


@dataclasses.dataclass
class TrainerConfig:
    num_workers: int = 20             # paper: m = 20
    steps: int = 500
    log_every: int = 50
    seed: int = 0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0


class Trainer:
    """Deprecated: delegates to the ``sync_ps`` topology, so shim and
    spec-built runs share one loop step for step."""

    def __init__(self, model, batch_fn: Callable[[int], dict],
                 tcfg: TrainerConfig, robust_cfg: RobustConfig,
                 opt_cfg: OptConfig, eval_fn: Optional[Callable] = None,
                 defense_cfg=None, device=None):
        from repro_torch.experiment.runner import resolve_device
        self.model = model
        self.batch_fn = batch_fn
        self.tcfg = tcfg
        self.robust_cfg = robust_cfg
        self.opt_cfg = opt_cfg
        self.eval_fn = eval_fn
        self.defense_cfg = defense_cfg
        self.device = resolve_device(device)
        self.params = model.init(
            torch.Generator(device=self.device).manual_seed(tcfg.seed))
        self.opt_state = init_opt_state(opt_cfg, self.params)
        self.defense_state = None
        if defense_cfg is not None:
            from repro_torch.defense.reputation import init_reputation
            self.defense_state = init_reputation(tcfg.num_workers,
                                                 device=self.device)
        self.history: list = []

    def _checkpoint_tree(self) -> dict:
        tree = {"params": self.params, "opt": self.opt_state}
        if self.defense_state is not None:
            tree["defense"] = self.defense_state
        return tree

    def restore(self, path: str) -> int:
        """Restore params/opt (and the reputation state, when defense is
        on) from a checkpoint written by :meth:`run`; returns its step."""
        from repro_torch.checkpoint.io import load_checkpoint
        tree, step = load_checkpoint(path, self._checkpoint_tree())
        self.params, self.opt_state = tree["params"], tree["opt"]
        if self.defense_state is not None:
            self.defense_state = tree["defense"]
        return step

    def run(self) -> list:
        from repro_torch.experiment.runner import plan_from_parts
        from repro_torch.experiment.topology import make_topology
        plan = plan_from_parts(
            model=self.model, batch_fn=self.batch_fn,
            robust_cfg=self.robust_cfg, opt_cfg=self.opt_cfg,
            num_workers=self.tcfg.num_workers, steps=self.tcfg.steps,
            seed=self.tcfg.seed, eval_fn=self.eval_fn,
            defense_cfg=self.defense_cfg, record_every=self.tcfg.log_every,
            checkpoint_path=self.tcfg.checkpoint_path,
            checkpoint_every=self.tcfg.checkpoint_every,
            telemetry_path=(self.defense_cfg.telemetry_path
                            if self.defense_cfg is not None else None),
            device=self.device)
        result = make_topology("sync_ps").run(
            plan, init_state=(self.params, self.opt_state,
                              self.defense_state))
        self.params = result.params
        self.opt_state = result.opt_state
        self.defense_state = result.defense_state
        self.robust_cfg = result.robust_cfg   # post-adapt_b effective config
        self.history = result.history
        return self.history
