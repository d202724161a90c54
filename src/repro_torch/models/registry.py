"""The uniform model API the trainer drives.

Port of ``repro/models/registry.py::Model`` for the paper's classifiers:
``init(gen) -> params``, ``forward(params, batch) -> (logits, aux)`` and
``loss(params, batch) -> scalar``.  Parameters are nested dicts of tensors
in the reference's layout; the LM zoo's cache and decode fields come with
ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable          # (torch.Generator) -> params on the generator's device
    forward: Callable       # (params, batch) -> (logits, aux)
    loss: Callable          # (params, batch) -> scalar
