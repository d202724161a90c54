"""FaultSpec: the declarative fault axis of a scenario (DESIGN.md §13).

A copy of ``repro/faults/spec.py`` (numpy-free, plain Python), so that both
packages parse and validate the same fault axis.

A fault names a *kind* (registered below, exactly like attacks register in
``core/registry.py``), the workers it afflicts, and the kind's parameters:

  FaultSpec(kind="crash", workers=(7, 8), step=40)        # die at round 40
  FaultSpec(kind="silent", workers=(3,))                  # omission, forever
  FaultSpec(kind="straggler", workers=(5,), delay_steps=2, jitter=1)
  FaultSpec(kind="flaky", workers=(9,), p_drop=0.3)       # lossy transport
  FaultSpec(kind="pod", workers=(0, 1, 2, 3),             # pod-level outage
            inner=FaultSpec(kind="crash", step=60))

Design rules mirror the attack axis:

* frozen + JSON-round-trippable: ``ScenarioSpec.faults`` is a tuple of
  these and survives ``to_json``/``from_json`` byte-identically;
* kinds are registry entries with their own validators, so an invalid
  fault fails at spec-build time with an actionable message;
* topologies declare which kinds they can simulate via the
  ``fault_allowlist`` metadata classvar (checked by the generic
  ``Topology.validate_spec``).

``pod`` is the fleet-level construct (ROADMAP direction 2): it wraps any
other kind over a worker group — semantically identical to setting that
kind's ``workers`` to the group, but it names the failure domain.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


class FaultError(ValueError):
    """A fault spec failed validation (raised pre-run, like SpecError)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: a registered kind over a set of workers."""
    kind: str = "crash"
    workers: Tuple[int, ...] = ()   # afflicted worker indices
    step: int = 0                   # crash: first round the worker misses
    delay_steps: int = 0            # straggler: extra rounds per submission
    jitter: int = 0                 # straggler: max extra rounds (uniform)
    p_drop: float = 0.0             # flaky: per-attempt drop probability
    inner: Optional["FaultSpec"] = None   # pod: the wrapped kind


# ---------------------------------------------------------------------------
# Kind registry (mirrors core.registry.register_attack)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultKindSpec:
    """Registry entry: the kind's name, the FaultSpec fields it consumes,
    whether the absence it causes is permanent (quorum shrinks for good),
    and its parameter validator."""
    name: str
    params: Tuple[str, ...]
    permanent: bool
    validator: Callable[[FaultSpec], None]


_FAULT_KINDS: Dict[str, FaultKindSpec] = {}


def register_fault(name: str, *, params: Tuple[str, ...] = (),
                   permanent: bool = False):
    """Decorator registering a fault-kind validator under ``name``."""
    def deco(validator):
        key = name.lower()
        if key in _FAULT_KINDS:
            raise ValueError(f"fault kind {key!r} already registered")
        _FAULT_KINDS[key] = FaultKindSpec(
            name=key, params=tuple(params), permanent=permanent,
            validator=validator)
        return validator
    return deco


def available_fault_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_FAULT_KINDS))


# Back-compat alias some call sites prefer (reads like the registry API).
def fault_kind_names() -> Tuple[str, ...]:
    return available_fault_kinds()


def get_fault_kind(name: str) -> FaultKindSpec:
    key = name.lower()
    if key not in _FAULT_KINDS:
        raise FaultError(f"unknown fault kind {name!r}; "
                         f"have {sorted(_FAULT_KINDS)}")
    return _FAULT_KINDS[key]


# ---------------------------------------------------------------------------
# Builtin kinds
# ---------------------------------------------------------------------------

@register_fault("crash", params=("step",), permanent=True)
def _validate_crash(f: FaultSpec) -> None:
    if f.step < 0:
        raise FaultError(f"crash fault needs step >= 0 (the first round "
                         f"the worker misses), got {f.step}")


@register_fault("silent", permanent=True)
def _validate_silent(f: FaultSpec) -> None:
    pass   # omission has no parameters


@register_fault("straggler", params=("delay_steps", "jitter"))
def _validate_straggler(f: FaultSpec) -> None:
    if f.delay_steps < 1:
        raise FaultError("straggler fault needs delay_steps >= 1 (extra "
                         f"rounds per submission), got {f.delay_steps}")
    if f.jitter < 0:
        raise FaultError(f"straggler jitter must be >= 0, got {f.jitter}")


@register_fault("flaky", params=("p_drop",))
def _validate_flaky(f: FaultSpec) -> None:
    if not 0.0 <= f.p_drop < 1.0:
        raise FaultError("flaky fault needs 0 <= p_drop < 1 (per-attempt "
                         f"drop probability), got {f.p_drop}")


@register_fault("pod", params=("inner",))
def _validate_pod(f: FaultSpec) -> None:
    if f.inner is None:
        raise FaultError("pod fault wraps another kind over a worker "
                         "group; set inner=FaultSpec(kind=...)")
    if f.inner.kind.lower() == "pod":
        raise FaultError("pod faults do not nest (inner.kind='pod')")
    inner_kind = get_fault_kind(f.inner.kind)
    inner_kind.validator(f.inner)
    if f.inner.workers:
        raise FaultError("pod fault ignores inner.workers — the pod's own "
                         "workers tuple IS the failure domain; leave "
                         "inner.workers empty")


# ---------------------------------------------------------------------------
# Validation over a scenario
# ---------------------------------------------------------------------------

def validate_fault(f: FaultSpec, num_workers: int) -> None:
    """One fault against its kind's validator + the worker range."""
    kind = get_fault_kind(f.kind)
    kind.validator(f)
    if not f.workers:
        raise FaultError(f"fault kind {f.kind!r} needs a non-empty workers "
                         "tuple (which workers it afflicts)")
    if len(set(f.workers)) != len(f.workers):
        raise FaultError(f"fault workers {f.workers} contain duplicates")
    bad = [w for w in f.workers if not 0 <= w < num_workers]
    if bad:
        raise FaultError(f"fault workers {bad} out of range for "
                         f"num_workers={num_workers}")
    if f.kind.lower() != "pod" and f.inner is not None:
        raise FaultError(f"fault kind {f.kind!r} does not take inner= "
                         "(only 'pod' wraps another kind)")


def expand_faults(faults: Tuple[FaultSpec, ...]) -> List[Tuple[str, int,
                                                               FaultSpec]]:
    """Flatten to primitive (kind, worker, params) triples — pods expand to
    their inner kind over the pod's worker group."""
    out: List[Tuple[str, int, FaultSpec]] = []
    for f in faults:
        if f.kind.lower() == "pod":
            assert f.inner is not None
            for w in f.workers:
                out.append((f.inner.kind.lower(), w, f.inner))
        else:
            for w in f.workers:
                out.append((f.kind.lower(), w, f))
    return out


def validate_faults(faults: Tuple[FaultSpec, ...], num_workers: int) -> None:
    """The whole fault axis: every fault valid, no worker afflicted twice,
    and enough never-faulty workers left for a quorum to exist at all
    (transient faults can empty a single round; permanent ones must not
    empty the run)."""
    for f in faults:
        validate_fault(f, num_workers)
    seen: Dict[int, str] = {}
    for kind, w, _ in expand_faults(faults):
        if w in seen:
            raise FaultError(
                f"worker {w} is afflicted by two faults ({seen[w]!r} and "
                f"{kind!r}); each worker takes at most one fault")
        seen[w] = kind
    permanent = sum(1 for kind, _, _ in expand_faults(faults)
                    if get_fault_kind(kind).permanent)
    if num_workers - permanent < 2:
        raise FaultError(
            f"{permanent} of {num_workers} workers are permanently faulty "
            "(crash/silent); at least 2 must survive for any aggregation "
            "quorum to exist")
