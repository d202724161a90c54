"""Scenario resolution + the single ``run_experiment(spec)`` entry point.

Port of ``repro/experiment/runner.py``.  ``resolve(spec, device)`` validates
the spec and builds the runtime bundle every topology consumes
(:class:`Plan`); ``run_experiment`` dispatches it to its topology plugin.
The deprecated legacy shims (``Trainer``, ``run_async_training``,
``run_streaming_training``) build their plan with :func:`plan_from_parts`
and enter the same topology loops.

The device defaults to ``cuda``: without a GPU, ``run_experiment`` raises
unless the caller asks for ``device="cpu"``, as the tests do.

A spec with a ``mesh`` (``"DxM"``) runs as D x M ``torch.distributed``
ranks, one per device of the reference's (data, model) mesh: inside a world
that is already made (``torchrun``), this process is one rank; from a single
process, ``run_experiment`` spawns the world itself
(:mod:`repro_torch.dist.launch`) and returns rank 0's result.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.robust import RobustConfig
from repro_torch.experiment.spec import ScenarioSpec, SpecError
from repro_torch.experiment.topology import (get_topology, make_topology,
                                             topologies_with)
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
    defense_cfg: Any                  # DefenseConfig | None
    telemetry_path: Optional[str]     # JSONL sink, or None
    num_workers: int
    steps: int
    seed: int
    record_every: int                 # history/eval cadence
    device: torch.device
    topology_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    # Observability switches (repro_torch.obs.ObsConfig | None): a property
    # of the invocation, not of the spec.
    obs: Any = None
    faults: tuple = ()                # spec.faults (FaultSpec tuple)
    # The checkpoint a resumed run continues from (an invocation property,
    # like obs).
    resume_path: Optional[str] = None
    # spec.compression when enabled, else None.
    compress_cfg: Any = None
    # The (data, model) HostMesh this process is a rank of, or None.
    mesh: Any = None


@dataclasses.dataclass
class ExperimentResult:
    """What a topology returns: the trajectory plus the final state.

    ``robust_cfg`` is the final effective config: it differs from the
    spec's when ``defense.adapt_b`` raised b mid-run.
    """
    spec: Optional[ScenarioSpec]
    history: List[dict]
    params: Any
    opt_state: Any = None
    defense_state: Optional[dict] = None
    final_metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    robust_cfg: Optional[RobustConfig] = None
    wall_time: float = 0.0
    # The completed requests of a ``serve`` run, with their tokens (the
    # reference keeps them inside its engine).
    requests: List[Any] = dataclasses.field(default_factory=list)

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


def validate(spec: ScenarioSpec, resume: Optional[str] = None) -> None:
    """``spec.validate()``, and the checks a resumed run adds."""
    spec.validate()
    if resume:
        if not get_topology(spec.topology).supports_resume:
            raise SpecError(
                f"topology {spec.topology!r} does not support resume; "
                f"resumable topologies: {topologies_with('supports_resume')}")
        if not spec.checkpoint_path:
            raise SpecError(
                "resume needs spec.checkpoint_path set (the resumed run "
                "keeps checkpointing to the same path)")


def resolve(spec: ScenarioSpec, *, device=None, obs: Any = None,
            resume: Optional[str] = None) -> Plan:
    """Validate ``spec`` and build the runtime bundle on ``device``."""
    validate(spec, resume)
    dev = resolve_device(device)
    mesh = None
    if spec.mesh:
        from repro_torch.dist.mesh import make_host_mesh, parse_mesh
        mesh = make_host_mesh(*parse_mesh(spec.mesh))
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

    telemetry = spec.telemetry_path or (
        spec.defense.telemetry_path if spec.defense is not None else None)

    return Plan(
        spec=spec,
        topology=spec.topology,
        model=model,
        batch_fn=batch_fn,
        eval_fn=eval_fn,
        robust_cfg=spec.effective_robust(),
        opt_cfg=opt_cfg,
        defense_cfg=spec.defense,
        telemetry_path=telemetry or None,
        num_workers=spec.num_workers,
        steps=spec.steps,
        seed=spec.seed,
        record_every=spec.record_every(),
        device=dev,
        topology_params=dict(spec.topology_params),
        checkpoint_path=spec.checkpoint_path or None,
        checkpoint_every=spec.checkpoint_every,
        obs=obs,
        faults=tuple(spec.faults),
        resume_path=resume or None,
        compress_cfg=spec.compression if spec.compression.enabled else None,
        mesh=mesh,
    )


def run_experiment(spec: ScenarioSpec, *, device=None, obs: Any = None,
                   resume: Optional[str] = None) -> ExperimentResult:
    """THE entry point: validate + resolve ``spec`` on ``device`` (default
    ``cuda``), dispatch to its topology plugin, return the
    :class:`ExperimentResult`.  ``obs`` (a ``repro_torch.obs.ObsConfig`` or
    None) arms the metrics registry and span tracer for this run.
    ``resume`` names a checkpoint written by an earlier run of the same
    spec: the topology restores params, optimizer, defense state, codec
    residual, generator state, live b/q and step from it (falling back to
    its ``.prev`` on corruption) and continues from the next step, bit for
    bit as the uninterrupted run.

    With ``spec.mesh`` and no ``torch.distributed`` world, the spec is
    validated here and then run by D x M spawned ranks over gloo on
    ``device``; every rank must end with bit-equal params, and a rank's
    exception fails the call."""
    import torch.distributed as dist
    if spec.mesh and not dist.is_initialized():
        from repro_torch.dist.launch import run_spawned
        validate(spec, resume)
        resolve_device(device)
        return run_spawned(spec, device=device, obs=obs, resume=resume)
    plan = resolve(spec, device=device, obs=obs, resume=resume)
    return make_topology(plan.topology).run(plan)


def plan_from_parts(*, model, batch_fn, robust_cfg, opt_cfg,
                    num_workers: int, steps: int, seed: int = 0,
                    topology: str = "sync_ps",
                    topology_params: Optional[dict] = None,
                    eval_fn=None, defense_cfg=None, record_every: int = 10,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 0,
                    telemetry_path: Optional[str] = None, obs: Any = None,
                    faults: tuple = (), resume_path: Optional[str] = None,
                    compress_cfg: Any = None, device=None) -> Plan:
    """A :class:`Plan` from already-built runtime objects, for the
    deprecated legacy shims (``spec=None`` on the result)."""
    return Plan(
        spec=None, topology=topology, model=model, batch_fn=batch_fn,
        eval_fn=eval_fn, robust_cfg=robust_cfg, opt_cfg=opt_cfg,
        defense_cfg=defense_cfg, telemetry_path=telemetry_path,
        num_workers=num_workers, steps=steps, seed=seed,
        record_every=max(record_every, 1), device=resolve_device(device),
        topology_params=dict(topology_params or {}),
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        obs=obs, faults=tuple(faults), resume_path=resume_path,
        compress_cfg=compress_cfg)


def _build_model_and_data(spec: ScenarioSpec, device: torch.device):
    """(model, batch_fn, eval_fn) for the spec's model × data cell.  An arch
    model trains on the token stream and has no eval, as in the
    reference."""
    from repro_torch.data.pipeline import ClassificationData, TokenStream

    m, ds = spec.model, spec.data
    global_batch = spec.num_workers * ds.batch_per_worker
    if m.kind == "arch":
        from repro_torch.configs import get_arch
        from repro_torch.models.registry import build_model
        cfg = get_arch(m.arch)
        stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=ds.seq_len,
                             global_batch=global_batch, seed=ds.seed,
                             device=device)
        return build_model(cfg, remat=m.remat), stream.batch, None
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
