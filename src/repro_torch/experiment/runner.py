"""Scenario resolution + the single ``run_experiment(spec)`` entry point.

Port of ``repro/experiment/runner.py``.  ``resolve(spec, device)`` validates
the spec and builds the runtime bundle every topology consumes
(:class:`Plan`); ``run_experiment`` dispatches it to its topology plugin.

The device defaults to ``cuda``: without a GPU, ``run_experiment`` raises
unless the caller asks for ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.robust import RobustConfig
from repro_torch.experiment.spec import ScenarioSpec, not_ported
from repro_torch.experiment.topology import make_topology
from repro_torch.optim.optimizers import OptConfig


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@dataclasses.dataclass
class Plan:
    """A resolved scenario: everything a topology needs to run the loop."""
    spec: Optional[ScenarioSpec]
    topology: str
    model: Any
    batch_fn: Callable[[int], dict]
    eval_fn: Optional[Callable]
    robust_cfg: RobustConfig          # effective (attack axis injected)
    opt_cfg: OptConfig                # effective (schedule bound)
    num_workers: int
    steps: int
    seed: int
    record_every: int                 # history/eval cadence
    device: torch.device


@dataclasses.dataclass
class ExperimentResult:
    """What a topology returns: the trajectory plus the final state."""
    spec: Optional[ScenarioSpec]
    history: List[dict]
    params: Any
    opt_state: Any = None
    final_metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    robust_cfg: Optional[RobustConfig] = None
    wall_time: float = 0.0

    @property
    def final_loss(self) -> Optional[float]:
        for rec in reversed(self.history):
            if "loss" in rec:
                return rec["loss"]
        return None

    @property
    def final_eval(self) -> Optional[float]:
        for rec in reversed(self.history):
            if "eval" in rec:
                return rec["eval"]
        return None



def resolve(spec: ScenarioSpec, *, device=None) -> Plan:
    """Validate ``spec`` and build the runtime bundle on ``device``."""
    spec.validate()
    dev = resolve_device(device)
    model, batch_fn, eval_fn = _build_model_and_data(spec, dev)

    opt_cfg = spec.opt
    if spec.schedule:
        from repro_torch.optim import schedules
        params = dict(spec.schedule_params)
        if spec.schedule in ("cosine_decay", "warmup_cosine"):
            params.setdefault("total_steps", spec.steps)
        fn = getattr(schedules, spec.schedule)
        opt_cfg = dataclasses.replace(
            opt_cfg, lr=fn(float(spec.opt.lr), **params))

    return Plan(
        spec=spec,
        topology=spec.topology,
        model=model,
        batch_fn=batch_fn,
        eval_fn=eval_fn,
        robust_cfg=spec.effective_robust(),
        opt_cfg=opt_cfg,
        num_workers=spec.num_workers,
        steps=spec.steps,
        seed=spec.seed,
        record_every=spec.record_every(),
        device=dev,
    )


def run_experiment(spec: ScenarioSpec, *, device=None,
                   resume: Optional[str] = None) -> ExperimentResult:
    """THE training entry point: validate + resolve ``spec`` on ``device``
    (default ``cuda``), dispatch to its topology plugin, return the
    :class:`ExperimentResult`."""
    if resume:
        raise not_ported("resume from a checkpoint", "item 9")
    plan = resolve(spec, device=device)
    return make_topology(plan.topology).run(plan)


def _build_model_and_data(spec: ScenarioSpec, device: torch.device):
    """(model, batch_fn, eval_fn) for the spec's model × data cell."""
    from repro_torch.data.pipeline import ClassificationData

    m, ds = spec.model, spec.data
    global_batch = spec.num_workers * ds.batch_per_worker
    data = ClassificationData(num_classes=ds.num_classes, dim=ds.dim,
                              noise=ds.noise, seed=ds.seed, device=device)
    test = data.test_set(1024)

    if m.kind == "cnn":
        from repro_torch.models.cnn import build_cnn_model, cnn_topk_accuracy
        size, ch = m.cnn_size, m.cnn_channels
        model = build_cnn_model(in_ch=ch, size=size)
        test = {"x": test["x"].reshape(-1, size, size, ch), "y": test["y"]}

        def batch_fn(step: int) -> dict:
            raw = data.batch(step, global_batch)
            return {"x": raw["x"].reshape(-1, size, size, ch),
                    "y": raw["y"]}

        return model, batch_fn, lambda p: cnn_topk_accuracy(p, test, k=3)

    from repro_torch.models.mlp import build_mlp_model, mlp_accuracy
    dims = m.dims or (ds.dim, 128, 128, ds.num_classes)
    model = build_mlp_model(dims=dims)
    return (model, lambda step: data.batch(step, global_batch),
            lambda p: mlp_accuracy(p, test))
