"""Topology plugin registry — how a scenario executes.

Port of ``repro/experiment/topology.py``.  A topology is the training-loop
shape; subclass :class:`Topology`, implement ``run``, decorate with
:func:`register_topology`.  This package has the paper's synchronous
parameter server only; the other reference topologies raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import ClassVar, Dict, Tuple, Type

from repro_torch.experiment.spec import ScenarioSpec, SpecError

UNPORTED_TOPOLOGIES = {
    "async_ps": "item 9",
    "streaming": "item 9",
    "serve": "item 12",
}


class Topology:
    """Base class for registered training topologies.

    ``run(plan, init_state=None)`` executes a resolved scenario
    (:class:`repro_torch.experiment.runner.Plan`); ``init_state`` optionally
    injects ``(params, opt_state)``.
    """

    name: ClassVar[str]
    param_names: ClassVar[Tuple[str, ...]] = ()  # valid topology_params keys

    def validate_spec(self, spec: ScenarioSpec) -> None:
        unknown = sorted(set(spec.topology_params) - set(self.param_names))
        if unknown:
            raise SpecError(
                f"unknown topology_params {unknown} for topology "
                f"{self.name!r}; valid keys: {sorted(self.param_names)}")

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


def get_topology(name: str) -> Type[Topology]:
    _ensure_builtins()
    key = name.lower()
    if key in UNPORTED_TOPOLOGIES:
        raise NotImplementedError(
            f"topology {name!r} is not ported to repro_torch yet (ROADMAP "
            f"queue 1 {UNPORTED_TOPOLOGIES[key]})")
    if key not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; "
                         f"have {sorted(_TOPOLOGIES)}")
    return _TOPOLOGIES[key]


def make_topology(name: str) -> Topology:
    return get_topology(name)()
