"""Builtin gradient codecs (port of ``repro/compress/codecs.py``, DESIGN.md
§14).

* ``dense``   — identity passthrough (the pipeline with zero quantization);
* ``topk``    — magnitude top-k sparsification with error feedback: the
  untransmitted mass accumulates in a per-worker residual and is retried
  next step (Stich et al. 2018); ``stateful``;
* ``signbit`` — signSGD 1-bit: one sign bit per coordinate (32x);
* ``int8``    — stochastic uniform quantization to 255 levels with one
  per-row scale; the rounding noise comes from
  :func:`stochastic_rounding_noise`.

Per-coordinate wire cost: dense 32 bits, topk ``ratio * 64`` bits (index +
value), signbit 1 bit, int8 8 bits.  ``torch.topk`` and the scatter are
torch ops, as the reference's ``lax.top_k`` is an XLA op outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.compress.spec import (Codec, CompressError, CompressionSpec,
                                       register_codec)

Payload = Dict[str, torch.Tensor]


def stochastic_rounding_noise(gen: torch.Generator,
                              u: torch.Tensor) -> torch.Tensor:
    """U[0, 1) noise of ``u``'s shape for the int8 codec's rounding (the
    reference draws ``jax.random.uniform(key, u.shape)``; tests replace
    this function to feed both codecs the same noise)."""
    return torch.rand(u.shape, generator=gen, dtype=u.dtype,
                      device=u.device)


@register_codec
class DenseCodec(Codec):
    """Identity passthrough."""

    name = "dense"

    def encode(self, u, state, gen):
        del gen
        return {"dense": u}, state

    def decode(self, payload, d):
        del d
        return payload["dense"]

    def payload_bytes(self, d: int) -> int:
        return 4 * d


def _topk_count(ratio: float, d: int) -> int:
    return max(1, int(round(ratio * d)))


@register_codec
class TopKCodec(Codec):
    """Top-k sparsification with error feedback."""

    name = "topk"
    stateful = True

    def init_state(self, m: int, d: int, device=None) -> torch.Tensor:
        # the per-worker residual: gradient mass not yet transmitted
        return torch.zeros((m, d), dtype=torch.float32, device=device)

    def encode(self, u, state, gen) -> Tuple[Payload, torch.Tensor]:
        del gen
        acc = u + state                       # error-feedback accumulator
        k = _topk_count(self.spec.ratio, u.shape[1])
        idx = torch.topk(acc.abs(), k, dim=1).indices        # (m, k)
        val = torch.gather(acc, 1, idx)
        sent = torch.zeros_like(acc).scatter(1, idx, val)
        return {"idx": idx.to(torch.int32), "val": val}, acc - sent

    def decode(self, payload, d):
        idx, val = payload["idx"].long(), payload["val"]
        return torch.zeros((idx.shape[0], d), dtype=val.dtype,
                           device=val.device).scatter(1, idx, val)

    def payload_bytes(self, d: int) -> int:
        # 4-byte index + 4-byte value per kept coordinate
        return 8 * _topk_count(self.spec.ratio, d)

    @classmethod
    def validate_spec(cls, spec: CompressionSpec) -> None:
        if not 0.0 < spec.ratio <= 1.0:
            raise CompressError(
                f"topk codec needs 0 < ratio <= 1 (fraction of "
                f"coordinates kept), got {spec.ratio}")


@register_codec
class SignBitCodec(Codec):
    """signSGD 1-bit: the sign plane is the whole payload; zero encodes as
    +1, so the wire format is a genuine bit plane."""

    name = "signbit"

    def encode(self, u, state, gen):
        del gen
        return {"sign": torch.where(u >= 0, 1.0, -1.0).to(u.dtype)}, state

    def decode(self, payload, d):
        del d
        return payload["sign"]

    def payload_bytes(self, d: int) -> int:
        return (d + 7) // 8


@register_codec
class Int8Codec(Codec):
    """Stochastic symmetric int8: 255 levels, one f32 scale per row
    (``scale = max|u| / 127``); stochastic rounding keeps the codec unbiased
    and the per-coordinate error under one step."""

    name = "int8"

    def encode(self, u, state, gen: Optional[torch.Generator]):
        if gen is None:
            raise ValueError("int8 codec needs a generator (stochastic "
                             "rounding); thread the step's generator")
        scale = torch.clamp(u.abs().amax(dim=1), min=1e-30) / 127.0
        x = u / scale[:, None]                           # in [-127, 127]
        q = torch.clamp(torch.floor(x + stochastic_rounding_noise(gen, u)),
                        -127, 127)
        return {"q": q.to(torch.int8), "scale": scale}, state

    def decode(self, payload, d):
        del d
        return payload["q"].float() * payload["scale"][:, None]

    def payload_bytes(self, d: int) -> int:
        return d + 4
