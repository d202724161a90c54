"""Structured per-step JSONL telemetry for the defense.

Port of ``repro/defense/telemetry.py``, with the same on-disk format: one
record per line,

    {"t": <unix time>, "kind": "train", "step": 12, "loss": 0.41,
     "suspicion": [...], "reputation": [...], "active": [...], "q_hat": 2}

``TelemetryWriter`` is a no-op without a path (so loops call ``log``
unconditionally), turns tensors and arrays into JSON lists, and flushes per
record so a killed run keeps what it wrote.  ``read_jsonl`` loads a file.
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

import numpy as np
import torch

#: Clamp for ±inf: the largest float64 that survives a strict-JSON
#: round-trip as a number.
INF_CLAMP = 1e308


def jsonify(value):
    """Convert tensors, numpy and Python values to JSON-safe types.

    NaN becomes ``null`` and ±inf ``±1e308``, so a number column never holds
    a string.
    """
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        if np.isfinite(value):
            return value
        if np.isnan(value):
            return None
        return INF_CLAMP if value > 0 else -INF_CLAMP
    if isinstance(value, dict):
        return {str(k): jsonify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonify(v) for v in value]
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.ndim == 0:
        return jsonify(arr.item())
    return [jsonify(v) for v in arr.tolist()]


class TelemetryWriter:
    """Append-only JSONL sink; ``path=None`` makes every call a no-op."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def log(self, kind: str, step: int, **metrics) -> None:
        """Write one record; tensors in ``metrics`` become lists."""
        if self._f is None:
            return
        rec = {"t": time.time(), "kind": kind, "step": int(step)}
        for k, v in metrics.items():
            rec[k] = jsonify(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TelemetryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> list:
    """Load every record of a telemetry file."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
