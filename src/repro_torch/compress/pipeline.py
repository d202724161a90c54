"""Compressed aggregation pipeline: encode -> corrupt -> decode -> reduce
(port of ``repro/compress/pipeline.py``, DESIGN.md §14).

The wire model:

1. each worker computes its gradient (generic Byzantine workers corrupt
   here, before encoding: a malicious gradient honestly encoded);
2. every worker encodes with the scenario's codec (error-feedback residual
   updates per worker);
3. the wire-level attacks (``bitplane_flip``, ``scale_inflate``) corrupt the
   first q workers' *encoded payloads*;
4. the server decodes all m payloads and hands the dequantized rows to the
   rule: ``reduce`` (through its CUDA kernel on the card, for phocas and
   trmean) or the defended ``reduce_gated_with_scores``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compress.spec import Codec
from repro_torch.core.attacks import AttackConfig, make_attack
from repro_torch.core.robust import (RobustConfig, flatten_stacked,
                                     unflatten_like)
from repro_torch.core.selection import gate_matrix

# Attacks that corrupt the encoded payload itself (step 3 above); they are
# also registered as row-wise attacks with dense-equivalent semantics.
ENCODED_ATTACKS = ("bitplane_flip", "scale_inflate")


def corrupt_payload(payload: dict, name: str, acfg: AttackConfig) -> dict:
    """Apply a wire-level attack to the first q workers' encoded rows.

    ``bitplane_flip`` negates every value the worker put on the wire (the
    sign plane, the int8 values, the top-k values or the raw f32s);
    ``scale_inflate`` multiplies the worker's magnitude carrier by
    ``inflate_scale``: the per-row scale where the format has one (int8),
    else the transmitted values.
    """
    q = acfg.num_byzantine
    out = dict(payload)

    def scaled(field, s):
        t = out[field].clone()
        t[:q] = t[:q] * s
        out[field] = t

    if name == "bitplane_flip":
        for field in ("sign", "val", "dense", "q"):
            if field in out:
                # int8 values lie in [-127, 127]: negation never overflows
                scaled(field, -1)
    elif name == "scale_inflate":
        s = acfg.inflate_scale
        if "scale" in out:
            scaled("scale", s)
        else:
            for field in ("sign", "val", "dense"):
                if field in out:
                    scaled(field, s)
    else:
        raise ValueError(f"not an encoded-domain attack: {name!r}")
    return out


def aggregate_compressed(u: torch.Tensor, cfg: RobustConfig, codec: Codec,
                         state: torch.Tensor,
                         gen: Optional[torch.Generator] = None, *,
                         active: Optional[torch.Tensor] = None,
                         with_scores: bool = False, step=None):
    """Aggregate an (m, d) worker matrix through the codec wire model.

    Returns ``(agg, scores_or_None, new_state)``, with the attack, gate and
    score semantics of ``core.robust.aggregate_matrix``; ``state`` is the
    codec's error-feedback residual.
    """
    uf = u.to(getattr(torch, cfg.agg_dtype))
    d = uf.shape[1]
    atk_name = cfg.attack.name.lower()
    attack = make_attack(cfg.attack)
    if attack is not None and gen is None:
        raise ValueError("attack configured but no generator supplied")
    if attack is not None and atk_name not in ENCODED_ATTACKS:
        uf = attack(gen, uf, step)
    payload, new_state = codec.encode(uf, state, gen)
    if attack is not None and atk_name in ENCODED_ATTACKS:
        payload = corrupt_payload(payload, atk_name, cfg.attack)
    uhat = codec.decode(payload, d)
    rule = cfg.rule_obj()
    if with_scores:
        agg, scores = rule.reduce_gated_with_scores(uhat, active)
        return agg, scores, new_state
    if active is not None:
        uhat = gate_matrix(uhat, active)
    return rule.reduce(uhat), None, new_state


def aggregate_compressed_tree(stacked, cfg: RobustConfig, codec: Codec,
                              state: torch.Tensor,
                              gen: Optional[torch.Generator] = None, *,
                              active: Optional[torch.Tensor] = None,
                              with_scores: bool = False, step=None):
    """Tree-level wrapper (mirrors ``aggregate_stacked_tree``): returns
    ``(tree, new_state)``, or ``(tree, scores, new_state)`` with
    ``with_scores=True``."""
    agg, scores, new_state = aggregate_compressed(
        flatten_stacked(stacked), cfg, codec, state, gen, active=active,
        with_scores=with_scores, step=step)
    tree = unflatten_like(agg, stacked)
    if with_scores:
        return tree, scores, new_state
    return tree, new_state


def roundtrip_matrix(u: torch.Tensor, codec: Codec,
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stateless encode -> decode round trip of an (m, d) matrix (the
    streaming topology's per-worker wire simulation)."""
    state = codec.init_state(*u.shape, device=u.device)
    payload, _ = codec.encode(u, state, gen)
    return codec.decode(payload, u.shape[1])


def bytes_per_round(codec: Codec, d: int, m: int, retries: int = 0) -> int:
    """Wire bytes one aggregation round costs: m submissions plus any
    flaky-retry resends (each resend re-ships the identical payload)."""
    return codec.payload_bytes(d) * (m + retries)
