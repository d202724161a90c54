"""CompressionSpec + the codec registry (port of ``repro/compress/spec.py``,
DESIGN.md §14).

A *codec* sits between per-worker gradient computation and robust
aggregation.  Codecs are registry plugins like rules, attacks and faults: a
:class:`Codec` subclass decorated with :func:`register_codec`, whose
``stateful`` classvar says whether it carries an ``(m, D)`` error-feedback
residual that the topology loops must thread and checkpoint.
:class:`CompressionSpec` is the frozen, JSON-round-trippable scenario axis
(``ScenarioSpec.compression``).

The codec contract:

* ``encode(u, state, gen) -> (payload, new_state)``: ``u`` is the ``(m, d)``
  worker matrix; ``payload`` a dict of tensors with leading axis m (the wire
  representation); stateless codecs return ``state`` unchanged.  ``gen``
  (a ``torch.Generator`` on ``u``'s device) draws the randomized rounding,
  where the reference folds a key out of the step key.
* ``decode(payload, d) -> (m, d)``: dequantized f32 rows.
* ``payload_bytes(d) -> int``: bytes one worker puts on the wire a step.
* ``init_state(m, d, device)``: the per-worker residual for ``stateful``
  codecs, a ``(0,)`` placeholder otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import torch


class CompressError(ValueError):
    """A compression spec failed validation (pre-run, like SpecError)."""


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """The declarative compression axis; ``codec="none"`` disables it and
    ``codec="dense"`` routes through the pipeline with the identity codec."""
    codec: str = "none"       # registered codec name ("none" = disabled)
    ratio: float = 0.01       # topk: fraction of coordinates kept per row

    @property
    def enabled(self) -> bool:
        return self.codec.lower() not in ("none", "")


class Codec:
    """Base class for registered gradient codecs (contract above)."""

    name: ClassVar[str] = ""
    stateful: ClassVar[bool] = False   # carries an (m, D) residual state

    def __init__(self, spec: CompressionSpec = CompressionSpec()):
        self.spec = spec

    def init_state(self, m: int, d: int, device=None) -> torch.Tensor:
        """Per-worker codec state; stateful codecs override this with a
        genuine (m, d) residual."""
        del m, d
        return torch.zeros((0,), dtype=torch.float32, device=device)

    def encode(self, u: torch.Tensor, state: torch.Tensor,
               gen: Optional[torch.Generator]
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        raise NotImplementedError

    def decode(self, payload: Dict[str, torch.Tensor], d: int
               ) -> torch.Tensor:
        raise NotImplementedError

    def payload_bytes(self, d: int) -> int:
        raise NotImplementedError

    @classmethod
    def validate_spec(cls, spec: CompressionSpec) -> None:
        """Per-codec parameter validation (raise CompressError)."""


_CODECS: Dict[str, Type[Codec]] = {}


def register_codec(cls: Type[Codec]) -> Type[Codec]:
    """Class decorator: make ``cls`` reachable by name everywhere."""
    key = cls.name.lower()
    if not key:
        raise ValueError(f"codec class {cls.__qualname__} has no name")
    prev = _CODECS.get(key)
    if prev is not None and prev is not cls:
        raise ValueError(f"codec {key!r} already registered by "
                         f"{prev.__module__}.{prev.__qualname__}")
    _CODECS[key] = cls
    return cls


def _ensure_builtins() -> None:
    # Deferred: the codecs module imports this one for the decorator.
    import repro_torch.compress.codecs  # noqa: F401


def available_codecs() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_CODECS))


def get_codec(name: str) -> Type[Codec]:
    _ensure_builtins()
    key = name.lower()
    if key not in _CODECS:
        raise CompressError(f"unknown codec {name!r}; "
                            f"have {sorted(_CODECS)}")
    return _CODECS[key]


def make_codec(spec: Optional[CompressionSpec]) -> Optional[Codec]:
    """Resolve a spec to a bound codec object (None = layer disabled)."""
    if spec is None or not spec.enabled:
        return None
    cls = get_codec(spec.codec)
    cls.validate_spec(spec)
    return cls(spec)


def validate_compression(spec: Any) -> None:
    """Codec-local validation: registry lookup + parameter ranges (the
    topology and mesh checks live in ``ScenarioSpec.validate``)."""
    if not isinstance(spec, CompressionSpec):
        raise CompressError(
            f"compression must be a CompressionSpec, got {type(spec)!r}")
    if not spec.enabled:
        return
    get_codec(spec.codec).validate_spec(spec)
