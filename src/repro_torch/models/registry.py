"""The uniform model API the trainer and the serving engine drive.

Port of ``repro/models/registry.py::Model``: ``init(gen) -> params``,
``forward(params, batch) -> (logits, aux)`` and ``loss(params, batch) ->
scalar`` for every model; the arch models built by :func:`build_model`
additionally have the decode cache ``init_cache`` / ``decode_step``, and
the decoder-only ones the paged serving path (``supports_paged``):

  init_paged_cache(num_blocks, block_tokens, device) -> block-pool cache
  prefill_paged(params, cache, tokens, block_tables) -> (logits, cache)
  decode_step_paged(params, cache, tokens, positions, block_tables)

Parameters are nested dicts of tensors in the reference's layout.  Every
family of ``repro_torch.configs`` is built: dense and MoE decoders with GQA
or MLA attention, the Mamba2 SSM, the hybrid attention + SSM stack and the
VLM backbone (``models/lm.py``), and the whisper encoder-decoder
(``models/encdec.py``, no paged path; its cross-attention cache is filled by
``encdec.prefill_cache``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable          # (torch.Generator) -> params on the generator's device
    forward: Callable       # (params, batch) -> (logits, aux)
    loss: Callable          # (params, batch) -> scalar
    init_cache: Optional[Callable] = None        # (batch, max_len, device)
    decode_step: Optional[Callable] = None       # (params, cache, tokens, pos)
    init_paged_cache: Optional[Callable] = None  # (blocks, block_tokens, device)
    decode_step_paged: Optional[Callable] = None
    prefill_paged: Optional[Callable] = None

    @property
    def supports_paged(self) -> bool:
        from repro_torch.models.stack import paged_supported
        return (self.init_paged_cache is not None
                and paged_supported(self.cfg))


def build_model(cfg, *, remat: str = "none") -> Model:
    """The :class:`Model` of an arch config (``repro_torch.configs``)."""
    from repro_torch.models import encdec, lm
    if cfg.is_encdec:
        return Model(
            cfg=cfg,
            init=lambda gen: encdec.init(gen, cfg),
            forward=lambda p, b: encdec.forward(p, cfg, b, remat=remat),
            loss=lambda p, b: encdec.loss_fn(p, cfg, b, remat=remat),
            init_cache=lambda bs, ml, device=None: encdec.init_cache(
                cfg, bs, ml, device),
            decode_step=lambda p, c, t, pos: encdec.decode_step(p, cfg, c, t,
                                                                pos))
    return Model(
        cfg=cfg,
        init=lambda gen: lm.init(gen, cfg),
        forward=lambda p, b: lm.forward(p, cfg, b, remat=remat),
        loss=lambda p, b: lm.loss_fn(p, cfg, b, remat=remat),
        init_cache=lambda bs, ml, device=None: lm.init_cache(cfg, bs, ml,
                                                             device),
        decode_step=lambda p, c, t, pos: lm.decode_step(p, cfg, c, t, pos),
        init_paged_cache=lambda nb, bt, device=None: lm.init_paged_cache(
            cfg, nb, bt, device),
        decode_step_paged=lambda p, c, t, pos, tab: lm.decode_step_paged(
            p, cfg, c, t, pos, tab),
        prefill_paged=lambda p, c, t, tab: lm.prefill_paged(p, cfg, c, t,
                                                            tab),
    )
