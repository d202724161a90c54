"""Encoder-decoder transformer (whisper backbone), a port of
``repro/models/encdec.py``.

The mel-spectrogram + conv frontend is a stub, as in the reference:
``batch["audio_embeds"]`` carries precomputed frame embeddings
(B, encoder_seq_len, frontend_dim).  Encoder: bidirectional self-attention
with sinusoidal positions.  Decoder: causal self-attention (cached) +
cross-attention to the encoder output (cached) + GLU MLP.  The encoder's
self-attention and the cross-attention are non-causal, so they take
``attention_core``'s ``_attend``, never the flash-attention kernel.

Encoder and decoder layers are stacked on a leading layer axis, as the
reference's ``vmap`` init stacks them; the reference's ``lax.scan`` over
them is a Python loop over layer views here.  Under any ``remat`` but
"none" each layer is recomputed in the backward pass (the reference wraps
its scan body in a plain ``jax.checkpoint``, so "dots" is "full" here),
through ``models/stack.py::checkpointed``.  The decode cache is written in
place: ``self`` per layer by the decode step, ``cross`` by
:func:`prefill_cache`.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as tree_util
from repro_torch.models import common as C
from repro_torch.models.stack import REMAT_MODES, checkpointed


def _sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(S, device=device)[:, None].float()
    dim = torch.arange(0, d, 2, device=device)[None].float()
    angle = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_enc_layers(gen, cfg) -> dict:
    dt, lead, dev = C.dtype_of(cfg), (cfg.encoder_layers,), gen.device
    return {
        "ln1": C.init_norm(cfg.d_model, dt, lead, dev),
        "attn": C.init_attention(gen, cfg, lead),
        "ln2": C.init_norm(cfg.d_model, dt, lead, dev),
        "mlp": C.init_mlp(gen, cfg, lead=lead),
    }


def _init_dec_layers(gen, cfg) -> dict:
    dt, lead, dev = C.dtype_of(cfg), (cfg.num_layers,), gen.device
    return {
        "ln1": C.init_norm(cfg.d_model, dt, lead, dev),
        "self_attn": C.init_attention(gen, cfg, lead),
        "ln_x": C.init_norm(cfg.d_model, dt, lead, dev),
        "cross_attn": C.init_attention(gen, cfg, lead),
        "ln2": C.init_norm(cfg.d_model, dt, lead, dev),
        "mlp": C.init_mlp(gen, cfg, lead=lead),
    }


def init(gen: torch.Generator, cfg) -> dict:
    dt, dev = C.dtype_of(cfg), gen.device
    return {
        "frontend_proj": C.init_linear(gen, cfg.frontend_dim, cfg.d_model,
                                       dt),
        "enc": _init_enc_layers(gen, cfg),
        "enc_norm": C.init_norm(cfg.d_model, dt, device=dev),
        "embed": C.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "dec": _init_dec_layers(gen, cfg),
        "dec_norm": C.init_norm(cfg.d_model, dt, device=dev),
        "lm_head": C.init_linear(gen, cfg.d_model, cfg.vocab_size, dt),
    }


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree, as views."""
    return tree_util.map(lambda x: x[i], tree)


def _scan(body, x, layers, n: int, remat: str, *consts):
    """``x = body(x, layer_i, *consts)`` for i < n; each layer recomputed in
    the backward pass unless ``remat`` is "none"."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r}; valid: {REMAT_MODES}")
    like, k = tree_util.map(lambda _: None, _layer(layers, 0)), len(consts)

    def fn(x, *args):
        p = tree_util.unflatten(like, list(args[k:]))
        return body(x, p, *args[:k]), torch.zeros((), device=x.device)

    for i in range(n):
        lp = _layer(layers, i)
        if remat == "none":   # aliases, or the modes' grads are not bit-equal
            x = body(x, lp, *(c.view_as(c) for c in consts))
        else:
            x, _ = checkpointed(fn, x, *consts, *tree_util.leaves(lp))
    return x


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_attn(p, cfg, x):
    B, S, d = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = C.linear(p["wq"], x).reshape(B, S, H, hd)
    k = C.linear(p["wk"], x).reshape(B, S, Kv, hd)
    v = C.linear(p["wv"], x).reshape(B, S, Kv, hd)
    pos = torch.arange(S, device=x.device)
    out = C.attention_core(q, k, v, pos, pos, causal=False)
    return C.linear(p["wo"], out.reshape(B, S, H * hd))


def _enc_layer(x, lp, cfg):
    h = C.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + _enc_attn(lp["attn"], cfg, h)
    h = C.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + C.mlp_block(lp["mlp"], h)


def encode(params, cfg, audio_embeds, *, remat: str = "none"
           ) -> torch.Tensor:
    """(B, F, frontend_dim) -> (B, F, d_model)."""
    x = C.linear(params["frontend_proj"],
                 audio_embeds.to(C.dtype_of(cfg)))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x = _scan(lambda x, lp: _enc_layer(x, lp, cfg), x, params["enc"],
              cfg.encoder_layers, remat)
    return C.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_attn(p, cfg, x, enc_kv):
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = C.linear(p["wq"], x).reshape(B, S, H, hd)
    k, v = enc_kv
    T = k.shape[1]
    out = C.attention_core(q, k, v, torch.arange(S, device=x.device),
                           torch.arange(T, device=x.device), causal=False)
    return C.linear(p["wo"], out.reshape(B, S, H * hd))


def _dec_layer(lp, cfg, x, enc_kv, *, positions, cache=None):
    h = C.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    sa, _ = C.attention_block(lp["self_attn"], cfg, h, positions=positions,
                              window=None, cache=cache)
    x = x + sa
    h = C.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    x = x + _cross_attn(lp["cross_attn"], cfg, h, enc_kv)
    h = C.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + C.mlp_block(lp["mlp"], h)


def _cross_kv(lp, cfg, enc_out):
    B, T, _ = enc_out.shape
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    k = C.linear(lp["cross_attn"]["wk"], enc_out).reshape(B, T, Kv, hd)
    v = C.linear(lp["cross_attn"]["wv"], enc_out).reshape(B, T, Kv, hd)
    return k, v


def forward(params, cfg, batch, *, remat: str = "none"):
    """Full enc-dec training forward -> (logits (B,S,V) f32, aux = 0)."""
    enc_out = encode(params, cfg, batch["audio_embeds"], remat=remat)
    x = C.embed(params["embed"], batch["tokens"]) * math.sqrt(cfg.d_model)

    def body(x, lp, enc_out):
        positions = torch.arange(x.shape[1], device=x.device)
        return _dec_layer(lp, cfg, x, _cross_kv(lp, cfg, enc_out),
                          positions=positions)

    x = _scan(body, x, params["dec"], cfg.num_layers, remat, enc_out)
    x = C.rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    logits = C.linear(params["lm_head"], x).float()
    return logits, torch.zeros((), device=logits.device)


def loss_fn(params, cfg, batch, *, remat: str = "none") -> torch.Tensor:
    logits, _ = forward(params, cfg, batch, remat=remat)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return nll.mean()


def init_cache(cfg, batch_size: int, max_len: int, device=None) -> dict:
    """Self-attn KV per decoder layer + the cross-attn KV (zeros until
    :func:`prefill_cache` fills it from the encoder output)."""
    dt = C.dtype_of(cfg)
    L, Kv, hd, F = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                    cfg.encoder_seq_len)

    def zeros(T):
        return torch.zeros((L, batch_size, T, Kv, hd), dtype=dt,
                           device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(F), "v": zeros(F)}}


def prefill_cache(params, cfg, cache, audio_embeds):
    """Run the encoder and put every decoder layer's cross-attention K/V
    into ``cache["cross"]``; returns the same cache."""
    enc_out = encode(params, cfg, audio_embeds)
    kv = [_cross_kv(_layer(params["dec"], i), cfg, enc_out)
          for i in range(cfg.num_layers)]
    cache["cross"] = {"k": torch.stack([k for k, _ in kv]),
                      "v": torch.stack([v for _, v in kv])}
    return cache


def decode_step(params, cfg, cache, tokens, pos):
    """One decoder token (tokens (B,1), pos an int) against the cached
    self/cross KV; the self-attention cache is written in place.  Returns
    (logits (B,1,V) f32, cache)."""
    x = C.embed(params["embed"], tokens) * math.sqrt(cfg.d_model)
    positions = torch.as_tensor(pos, device=tokens.device).long().reshape(-1)
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    xk, xv = cache["cross"]["k"], cache["cross"]["v"]
    for i in range(cfg.num_layers):
        x = _dec_layer(_layer(params["dec"], i), cfg, x, (xk[i], xv[i]),
                       positions=positions,
                       cache={"k": sk[i], "v": sv[i]})
    x = C.rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return C.linear(params["lm_head"], x).float(), cache
