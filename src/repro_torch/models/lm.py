"""Decoder-only language model, a port of ``repro/models/lm.py`` for the
dense, MoE, SSM (mamba2), hybrid (hymba) and VLM (internvl2) families:
training forward and loss (with the MoE load-balance aux), the ring-cache
decode step (MLA layers keep latent caches, SSM layers their conv history
and state), and the paged serving path.

VLM (``cfg.num_patches > 0``): the stub vision frontend supplies precomputed
patch embeddings (``batch["patch_embeds"]``, (B, num_patches, vit_dim)); a
2-layer MLP projector (tanh GELU, as ``jax.nn.gelu``'s default) maps them to
d_model and they replace the first ``num_patches`` positions of the
sequence, which the loss masks out.  Decoding embeds tokens only, as in the
reference.

``init(gen, cfg)`` draws the parameters from a ``torch.Generator`` on the
device they go to.  Caches are written in place (``models/common.py``).

On a mesh every family's layers compute on this rank's blocks
(``models/common.py``, ``models/ssm.py``): the vocab-sharded table and
``lm_head`` (or gemma2's tied table) give vocab blocks of the logits,
which are gathered before the final softcap, so the loss and the argmax
see every logit; the VLM projector's ``fc1`` is column-parallel and its
``fc2`` row-parallel, the tanh GELU between them on this rank's block.
In the FSDP streaming step the params are shards, gathered into those
blocks where they are used (``models/common.py::gathered``): the
embedding table at the lookup and again at a tied head, the final norm,
the head and the projector, the stack's layers a period at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import stack as ST


def init(gen: torch.Generator, cfg) -> dict:
    dt = C.dtype_of(cfg)
    params = {
        "embed": C.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "stack": ST.init_stack(gen, cfg),
        "final_norm": C.init_norm(cfg.d_model, dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = C.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          dt)
    if cfg.num_patches:
        h = cfg.d_model
        params["projector"] = {"fc1": C.init_linear(gen, cfg.vit_dim, h, dt),
                               "fc2": C.init_linear(gen, h, h, dt)}
    return params


def _embed_tokens(params, cfg, tokens) -> torch.Tensor:
    return (C.embed(C.gathered(params["embed"], "embed"), tokens,
                    cfg.vocab_size) * math.sqrt(cfg.d_model))


def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    x = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.num_patches:
        pe = batch["patch_embeds"].to(x.dtype)
        pj = C.gathered(params["projector"], "projector")
        h = C.col_linear(pj["fc1"], pe, C.model_copy(pe), cfg.d_model,
                         keep_block=True)
        proj = C.row_linear(pj["fc2"], F.gelu(h, approximate="tanh"),
                            cfg.d_model)
        x = torch.cat([proj, x[:, cfg.num_patches:]], dim=1)
    return x


def _logits(params, cfg, x) -> torch.Tensor:
    x = C.rmsnorm(C.gathered(params["final_norm"], "final_norm"), x,
                  cfg.norm_eps)
    if cfg.tie_embeddings:
        table = C.gathered(params["embed"], "embed")["table"]
        logits = C.col_linear({"w": table.T}, x, C.model_copy(x),
                              cfg.vocab_size)
    else:
        logits = C.col_linear(C.gathered(params["lm_head"], "lm_head"), x,
                              C.model_copy(x), cfg.vocab_size)
    return C.softcap(logits.float(), cfg.final_logit_softcap)


def forward(params, cfg, batch, *, remat: str = "none"):
    """Training/prefill forward: batch['tokens'] (B,S) -> (logits (B,S,V),
    aux)."""
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = ST.stack_fwd(params["stack"], cfg, x, positions=positions,
                             remat=remat)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg, batch, *, remat: str = "none") -> torch.Tensor:
    """Next-token cross-entropy + the MoE aux (zero for a dense model); a
    VLM's patch positions are masked out (a loss of 0 when every position
    is a patch, as the reference's)."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"].long()                  # (B,S) next tokens
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if not cfg.num_patches:
        return nll.mean() + aux
    pos = torch.arange(nll.shape[1], device=nll.device)[None]
    mask = (pos >= cfg.num_patches).to(nll.dtype)
    return (torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
            + aux)


def init_cache(cfg, batch_size: int, max_len: int, device=None) -> dict:
    return ST.init_stack_cache(cfg, batch_size, max_len, device)


def decode_step(params, cfg, cache, tokens, pos):
    """One decode step (tokens (B,1), pos an int) or a batched prefill
    (tokens (B,S0), pos = arange(S0): one pass writes the whole prompt into
    the cache).  Returns (logits (B,S,V), cache)."""
    positions = C.step_positions(pos, tokens.device)
    x = _embed_tokens(params, cfg, tokens)
    x, cache, _ = ST.stack_fwd(params["stack"], cfg, x, positions=positions,
                               cache=cache)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Paged serving path (DESIGN.md §11)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, num_blocks: int, block_tokens: int,
                     device=None) -> dict:
    """Block-pool KV cache; see stack.init_stack_paged_cache (raises
    NotImplementedError for architectures the paged path does not cover)."""
    return ST.init_stack_paged_cache(cfg, num_blocks, block_tokens, device)


def decode_step_paged(params, cfg, cache, tokens, positions, block_tables):
    """One paged decode step with per-request positions.  tokens (B,1),
    positions (B,), block_tables (B, max_blocks) integer tensors.
    Returns (logits (B,1,V), cache)."""
    x = _embed_tokens(params, cfg, tokens)
    x, cache = ST.stack_fwd_paged(params["stack"], cfg, x,
                                  positions=positions.long(),
                                  block_tables=block_tables.long(),
                                  cache=cache)
    return _logits(params, cfg, x), cache


def prefill_paged(params, cfg, cache, tokens, block_tables):
    """Batched paged prefill: one forward pass over whole prompts (B,S0)
    aligned at position 0, k/v written into the block pool.
    Returns (logits (B,S0,V), cache)."""
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, cache = ST.stack_fwd_paged(params["stack"], cfg, x,
                                  positions=positions,
                                  block_tables=block_tables.long(),
                                  cache=cache, prefill=True)
    return _logits(params, cfg, x), cache
