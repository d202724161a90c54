"""Rule and attack registries: the aggregation stack's single dispatch point.

Port of ``repro/core/registry.py``.  A rule is an :class:`AggregatorRule`
subclass decorated with :func:`register_rule`; an attack is a factory
``AttackConfig -> (gen, u, step=None) -> u_tilde`` decorated with
:func:`register_attack`.  Built-ins register when ``repro_torch.core
.aggregators`` / ``repro_torch.core.attacks`` / the ``repro_torch.core.rules``
plugin package import; every lookup triggers those imports.

Backend strings keep the reference's names: ``"pallas"`` means the
hand-written CUDA kernel, ``"xla"`` the plain PyTorch path, and ``"auto"`` the
kernel for a CUDA tensor and the plain path for a CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional, Tuple, Type

import torch

from repro_torch.core.selection import gate_matrix, vector_median

BACKENDS = ("auto", "pallas", "xla")

# Reference rules not ported yet, with the ROADMAP queue item that brings
# each.
UNPORTED_RULES = {
    "signvote": "ROADMAP queue 1 item 13",
}


@dataclasses.dataclass(frozen=True)
class RuleParams:
    """The union of per-rule parameters a registered rule may consume; each
    rule reads only the fields its metadata declares (``uses_b`` /
    ``uses_q`` / ...)."""
    b: int = 0                            # trim count (trmean/phocas family)
    q: int = 0                            # assumed Byzantine count (Krum)
    multikrum_k: Optional[int] = None     # Multi-Krum selection size (m-q-2)
    geomedian_iters: int = 8              # Weiszfeld iteration count
    backend: str = "auto"                 # auto | pallas | xla


class AggregatorRule:
    """Base class for registered aggregation rules.

    Subclasses set ``name`` (and ``coordinate_wise`` / ``resilience`` /
    ``uses_b`` / ``uses_q`` / ``has_kernel`` / ``emits_scores`` /
    ``fused_gate``) and implement ``_reduce_plain`` (and
    ``_reduce_kernel`` with ``has_kernel = True``).  The sharded hooks of the
    reference (``reduce_sharded*``) come with the distributed layouts.
    """

    name: ClassVar[str]
    coordinate_wise: ClassVar[bool] = True
    resilience: ClassVar[str] = "none"    # dimensional | classic | none
    uses_b: ClassVar[bool] = False        # spec.validate checks b's range
    uses_q: ClassVar[bool] = False        # spec.validate checks q's range
    has_kernel: ClassVar[bool] = False    # declares a CUDA _reduce_kernel
    emits_scores: ClassVar[bool] = False  # informative reduce_with_scores
    fused_gate: ClassVar[bool] = False    # one-pass reduce_gated_with_scores

    def __init__(self, params: RuleParams = RuleParams()):
        self.params = params
        self.backend = resolve_backend(type(self), params.backend)

    def uses_kernel(self, u: torch.Tensor) -> bool:
        """Whether ``u`` goes to the CUDA kernel: ``backend="pallas"``, or
        ``"auto"`` on a CUDA tensor."""
        return self.backend == "pallas" or (self.backend == "auto"
                                            and u.is_cuda)

    def reduce(self, u: torch.Tensor) -> torch.Tensor:
        """Aggregate an (m, ...) worker matrix to (...)."""
        if self.uses_kernel(u):
            return self._reduce_kernel(u)
        return self._reduce_plain(u)

    def reduce_with_scores(self, u: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Aggregate AND emit (m,) per-worker suspicion scores in [0, 1]
        (larger = more suspicious).  Rules whose statistics carry a
        per-worker signal override this and set ``emits_scores``; the
        default scores are all zero, as in the reference."""
        return self.reduce(u), torch.zeros((u.shape[0],),
                                           dtype=torch.float32,
                                           device=u.device)

    def reduce_gated_with_scores(
            self, u: torch.Tensor, active: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The defended aggregation: scores of the RAW submissions, and the
        aggregate of the gated matrix (``active`` ejected rows replaced by
        the median row; ``active=None`` = no gate).  This default composes
        the two passes; rules with ``fused_gate`` override it."""
        agg, scores = self.reduce_with_scores(u)
        if active is not None:
            gated = gate_matrix(u, active)
            if gated is not u:      # no worker ejected: agg already is it
                agg = self.reduce(gated)
        return agg, scores

    def _reduce_plain(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _reduce_kernel(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"rule {self.name!r} sets has_kernel but lacks _reduce_kernel")


# ---------------------------------------------------------------------------
# Suspicion-score contract: (m,) scores in [0, 1], 0 = conforming, 1 =
# maximally suspicious.  The normalizers live here so the core import graph
# stays closed; repro_torch.defense.scores re-exports them.
# ---------------------------------------------------------------------------

def drop_frequency_scores(drop_counts: torch.Tensor, ncoords,
                          baseline: float) -> torch.Tensor:
    """Normalize per-worker drop counts into suspicion scores.

    ``drop_counts[i]`` counts the coordinates where worker i was dropped,
    out of ``ncoords``; ``baseline`` is the frequency an exchangeable benign
    worker expects (trmean 2b/m, phocas b/m), so benign workers land near 0
    and a consistently dropped worker near 1.
    """
    ncoords = torch.as_tensor(ncoords, dtype=torch.float32,
                              device=drop_counts.device)
    freq = drop_counts / torch.clamp(ncoords, min=1.0)
    denom = max(1.0 - baseline, 1e-6)
    return torch.clamp((freq - baseline) / denom, 0.0, 1.0)


def distance_ratio_scores(raw: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """Normalize nonnegative per-worker distance statistics into suspicion
    scores: ``1 - median/raw`` maps the median worker to 0 and far outliers
    toward 1; a median of ~0 gives all-zero scores.  The median is
    ``jnp.median``'s: a NaN statistic makes every score NaN, as there."""
    med = vector_median(raw)
    out = torch.clamp(1.0 - med / torch.clamp(raw, min=eps), 0.0, 1.0)
    return torch.where(med <= eps, torch.zeros_like(out), out)


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
    import repro_torch.core.rules        # noqa: F401  (single-file plugins)


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


def coordinate_wise_rules() -> Tuple[str, ...]:
    return tuple(n for n in available_rules() if _RULES[n].coordinate_wise)


def vector_wise_rules() -> Tuple[str, ...]:
    return tuple(n for n in available_rules()
                 if not _RULES[n].coordinate_wise)


def robust_rules() -> Tuple[str, ...]:
    """Rules with any resilience claim (classic or dimensional)."""
    return tuple(n for n in available_rules()
                 if _RULES[n].resilience != "none")


def kernel_rules() -> Tuple[str, ...]:
    return tuple(n for n in available_rules() if _RULES[n].has_kernel)


def score_rules() -> Tuple[str, ...]:
    """Rules whose ``reduce_with_scores`` emits informative suspicion."""
    return tuple(n for n in available_rules() if _RULES[n].emits_scores)


def fused_gate_rules() -> Tuple[str, ...]:
    """Rules whose gated defense hook is a one-pass override."""
    return tuple(n for n in available_rules() if _RULES[n].fused_gate)


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
