"""Topology plugin registry — how a scenario executes.

Port of ``repro/experiment/topology.py``.  A topology is the training-loop
shape; subclass :class:`Topology`, set the metadata classvars, implement
``run``, decorate with :func:`register_topology`.  The metadata drives the
generic spec validation (:meth:`Topology.validate_spec`): which scenario
features the loop supports (defense, adaptive b, resume, compression and
its error-feedback state, a device mesh), which attacks and fault kinds it
can simulate, whether it needs a streaming-capable rule, and which
``topology_params`` keys it consumes.  The messages are the reference's.
"""
from __future__ import annotations

from typing import ClassVar, Dict, Optional, Tuple, Type

from repro_torch.experiment.spec import ScenarioSpec, SpecError


class Topology:
    """Base class for registered training topologies.

    ``run(plan, init_state=None)`` executes a resolved scenario
    (:class:`repro_torch.experiment.runner.Plan`); ``init_state`` optionally
    injects pre-built state (each topology documents its shape).
    """

    # --- metadata (override in subclasses) ---
    name: ClassVar[str]
    supports_mesh: ClassVar[bool] = False      # spec.mesh usable
    supports_defense: ClassVar[bool] = False   # spec.defense usable
    supports_adapt_b: ClassVar[bool] = False   # defense.adapt_b usable
    param_names: ClassVar[Tuple[str, ...]] = ()  # valid topology_params keys
    # None = every registered attack; otherwise the simulatable subset.
    attack_allowlist: ClassVar[Optional[Tuple[str, ...]]] = None
    requires_streaming_rule: ClassVar[bool] = False
    # Fault kinds the loop's deadline-quorum collection can simulate:
    # () = faults unsupported (the safe default), None = every kind.
    fault_allowlist: ClassVar[Optional[Tuple[str, ...]]] = ()
    supports_resume: ClassVar[bool] = False    # run_experiment(resume=...)
    # Does the loop thread the codec wire model, and can it carry
    # per-worker error-feedback state across steps?
    supports_compression: ClassVar[bool] = False
    supports_stateful_codecs: ClassVar[bool] = False

    def validate_spec(self, spec: ScenarioSpec) -> None:
        from repro_torch.core import registry

        if spec.mesh and not self.supports_mesh:
            raise SpecError(
                f"topology {self.name!r} does not support a device mesh; "
                f"drop mesh={spec.mesh!r} or use one of "
                f"{topologies_with('supports_mesh')}")
        if spec.defense is not None and not self.supports_defense:
            raise SpecError(
                f"topology {self.name!r} does not support the defense loop; "
                f"drop spec.defense or use one of "
                f"{topologies_with('supports_defense')}")
        if (spec.defense is not None and spec.defense.adapt_b
                and not self.supports_adapt_b):
            raise SpecError(
                f"defense.adapt_b (online b/q re-tuning) is only available "
                f"on topologies {topologies_with('supports_adapt_b')}, not "
                f"{self.name!r}")
        unknown = sorted(set(spec.topology_params) - set(self.param_names))
        if unknown:
            raise SpecError(
                f"unknown topology_params {unknown} for topology "
                f"{self.name!r}; valid keys: {sorted(self.param_names)}")
        atk = spec.effective_attack().name.lower()
        if (atk not in ("none", "") and self.attack_allowlist is not None
                and atk not in self.attack_allowlist):
            raise SpecError(
                f"attack {atk!r} cannot be simulated on topology "
                f"{self.name!r} (supported: {self.attack_allowlist})")
        if spec.faults:
            allow = self.fault_allowlist
            if allow is not None and not allow:
                raise SpecError(
                    f"topology {self.name!r} has no deadline-quorum "
                    "collection (fault_allowlist is empty); run faults on "
                    f"{[t for t in available_topologies() if get_topology(t).fault_allowlist != ()]}")
            if allow is not None:
                from repro_torch.faults.spec import expand_faults
                bad = sorted({k for k, _, _ in expand_faults(spec.faults)
                              if k not in allow})
                if bad:
                    raise SpecError(
                        f"fault kind(s) {bad} cannot be simulated on "
                        f"topology {self.name!r} (supported: "
                        f"{sorted(allow)})")
        if spec.compression.enabled:
            if not self.supports_compression:
                raise SpecError(
                    f"topology {self.name!r} does not thread the gradient-"
                    "compression wire model; run compression on "
                    f"{topologies_with('supports_compression')}")
            from repro_torch.compress.spec import get_codec
            if (get_codec(spec.compression.codec).stateful
                    and not self.supports_stateful_codecs):
                raise SpecError(
                    f"codec {spec.compression.codec!r} carries per-worker "
                    "error-feedback state, which topology "
                    f"{self.name!r} cannot thread across steps; use a "
                    "stateless codec or one of "
                    f"{topologies_with('supports_stateful_codecs')}")
        if self.requires_streaming_rule:
            if not registry.get_rule(spec.robust.rule).supports_streaming:
                raise SpecError(
                    f"topology {self.name!r} needs a streaming-capable rule "
                    f"(supports_streaming); {spec.robust.rule!r} is not one "
                    f"of {registry.streaming_rules()}")

    def run(self, plan, init_state=None):
        raise NotImplementedError


_TOPOLOGIES: Dict[str, Type[Topology]] = {}


def register_topology(cls: Type[Topology]) -> Type[Topology]:
    """Class decorator: make ``cls`` reachable by name everywhere."""
    name = cls.name.lower()
    prev = _TOPOLOGIES.get(name)
    if prev is not None and prev is not cls:
        raise ValueError(f"topology {name!r} already registered by "
                         f"{prev.__module__}.{prev.__qualname__}")
    _TOPOLOGIES[name] = cls
    return cls


def _ensure_builtins() -> None:
    # Deferred: the builtin topologies import this module for the decorator.
    import repro_torch.experiment.topologies  # noqa: F401


def available_topologies() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_TOPOLOGIES))


def topologies_with(flag: str) -> list:
    """The registered topologies whose metadata ``flag`` is set."""
    return [t for t in available_topologies()
            if getattr(get_topology(t), flag)]


def get_topology(name: str) -> Type[Topology]:
    _ensure_builtins()
    key = name.lower()
    if key not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; "
                         f"have {sorted(_TOPOLOGIES)}")
    return _TOPOLOGIES[key]


def make_topology(name: str) -> Topology:
    return get_topology(name)()
