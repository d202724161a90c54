"""Rule and attack registries: the aggregation stack's single dispatch point.

Port of ``repro/core/registry.py``.  A rule is an :class:`AggregatorRule`
subclass decorated with :func:`register_rule`; an attack is a factory
``AttackConfig -> (gen, u, step=None) -> u_tilde`` decorated with
:func:`register_attack`.  Built-ins register when ``repro_torch.core
.aggregators`` / ``repro_torch.core.attacks`` import; every lookup triggers
those imports.

Backend strings keep the reference's names: ``"pallas"`` means the
hand-written CUDA kernel, ``"xla"`` the plain PyTorch path, and ``"auto"`` the
kernel for a CUDA tensor and the plain path for a CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Tuple, Type

import torch

BACKENDS = ("auto", "pallas", "xla")

# Reference rules this slice does not port yet, with the ROADMAP queue item
# that brings each.
UNPORTED_RULES = {
    "krum": "ROADMAP queue 1 item 8",
    "multikrum": "ROADMAP queue 1 item 8",
    "geomedian": "ROADMAP queue 1 item 8",
    "mediam": "ROADMAP queue 1 item 8",
    "mom": "ROADMAP queue 1 item 8",
    "signvote": "ROADMAP queue 1 item 13",
}


@dataclasses.dataclass(frozen=True)
class RuleParams:
    """The per-rule parameters the ported rules consume."""
    b: int = 0                            # trim count (trmean/phocas family)
    backend: str = "auto"                 # auto | pallas | xla


class AggregatorRule:
    """Base class for registered aggregation rules.

    Subclasses set ``name`` (and ``uses_b`` / ``has_kernel``) and implement
    ``_reduce_plain`` (and ``_reduce_kernel`` with ``has_kernel = True``).
    """

    name: ClassVar[str]
    uses_b: ClassVar[bool] = False        # spec.validate checks b's range
    has_kernel: ClassVar[bool] = False    # declares a CUDA _reduce_kernel

    def __init__(self, params: RuleParams = RuleParams()):
        self.params = params
        self.backend = resolve_backend(type(self), params.backend)

    def reduce(self, u: torch.Tensor) -> torch.Tensor:
        """Aggregate an (m, ...) worker matrix to (...)."""
        if self.backend == "pallas" or (self.backend == "auto"
                                        and u.is_cuda):
            return self._reduce_kernel(u)
        return self._reduce_plain(u)

    def _reduce_plain(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _reduce_kernel(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"rule {self.name!r} sets has_kernel but lacks _reduce_kernel")


def resolve_backend(rule_cls: Type[AggregatorRule], requested: str) -> str:
    """Resolve a requested backend against the rule's declared kernels.

    Returns ``"pallas"``, ``"xla"``, or ``"auto"`` for a rule with a kernel
    whose choice waits for the tensor's device.
    """
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}; have {BACKENDS}")
    if requested == "pallas" and not rule_cls.has_kernel:
        raise ValueError(
            f"backend='pallas' but rule {rule_cls.name!r} declares no "
            f"kernel; rules with kernels: {kernel_rules()}")
    if requested == "auto" and not rule_cls.has_kernel:
        return "xla"
    return requested


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------

_RULES: Dict[str, Type[AggregatorRule]] = {}


def register_rule(cls: Type[AggregatorRule]) -> Type[AggregatorRule]:
    """Class decorator: make ``cls`` available to the whole stack by name."""
    name = cls.name.lower()
    prev = _RULES.get(name)
    if prev is not None and prev is not cls:
        raise ValueError(f"aggregation rule {name!r} already registered "
                         f"by {prev.__module__}.{prev.__qualname__}")
    _RULES[name] = cls
    return cls


def _ensure_builtins() -> None:
    # Deferred: these modules import this one for the decorators.
    import repro_torch.core.aggregators  # noqa: F401
    import repro_torch.core.attacks      # noqa: F401


def available_rules() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_RULES))


def get_rule(name: str) -> Type[AggregatorRule]:
    _ensure_builtins()
    key = name.lower()
    if key in UNPORTED_RULES:
        raise NotImplementedError(
            f"rule {name!r} is not ported to repro_torch yet "
            f"({UNPORTED_RULES[key]}); ported rules: {sorted(_RULES)}")
    if key not in _RULES:
        raise ValueError(f"unknown aggregation rule {name!r}; "
                         f"have {sorted(_RULES)}")
    return _RULES[key]


def make_rule(name: str, params: RuleParams = RuleParams()) -> AggregatorRule:
    return get_rule(name)(params)


def kernel_rules() -> Tuple[str, ...]:
    return tuple(n for n in available_rules() if _RULES[n].has_kernel)


# ---------------------------------------------------------------------------
# Attack registry
# ---------------------------------------------------------------------------

ATTACK_KINDS = ("classic", "dimensional", "adaptive")


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """A registered attack: factory + the metadata the benchmarks read.

    ``step_aware`` attacks take a third ``step`` argument; without one they
    assume the worst case (post-trigger strike phase).
    """
    name: str
    factory: Callable                     # AttackConfig -> attack closure
    kind: str                             # classic | dimensional | adaptive
    paper_q: int = 0                      # Byzantine count in the paper's runs
    step_aware: bool = False


_ATTACKS: Dict[str, AttackSpec] = {}


def register_attack(name: str, *, kind: str, paper_q: int = 0,
                    step_aware: bool = False):
    """Decorator for attack factories ``AttackConfig -> (gen, u) -> u~``."""
    if kind not in ATTACK_KINDS:
        raise ValueError(
            f"attack kind must be one of {ATTACK_KINDS}, got {kind!r}")

    def deco(factory):
        key = name.lower()
        prev = _ATTACKS.get(key)
        if prev is not None and prev.factory is not factory:
            raise ValueError(f"attack {key!r} already registered")
        _ATTACKS[key] = AttackSpec(name=key, factory=factory, kind=kind,
                                   paper_q=paper_q, step_aware=step_aware)
        return factory

    return deco


def available_attacks() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_ATTACKS))


def get_attack_spec(name: str) -> AttackSpec:
    _ensure_builtins()
    key = name.lower()
    if key not in _ATTACKS:
        raise ValueError(f"unknown attack {name!r}; have {sorted(_ATTACKS)}")
    return _ATTACKS[key]
