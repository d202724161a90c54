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

On a mesh the layers compute tensor-parallel on this rank's blocks, as the
decoders of ``models/common.py`` do: ``frontend_proj`` is column-parallel
(its output gathered), the encoder's self-attention, the decoder's self-
and cross-attention run on this rank's heads (the cross-attention K/V of
:func:`prefill_cache` and of the cache too; heads the model axes do not
split take ``models/common.py::head_mode``'s paths), the GLU MLPs split their
hidden width, the vocab-sharded table is looked up on this rank's rows and
``lm_head`` gives vocab blocks of the logits, gathered before the loss;
a leaf that ``tree_pspecs`` leaves whole computes whole.
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


def _scan(body, x, layers, n: int, remat: str, *consts, path: str):
    """``x = body(x, layer_i, *consts)`` for i < n over the layer-stacked
    params at ``path``; each layer recomputed in the backward pass unless
    ``remat`` is "none", its FSDP shards gathered inside."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r}; valid: {REMAT_MODES}")
    k = len(consts)

    def fn_of(like, i):
        def fn(x, *args):
            p = C.gathered(tree_util.unflatten(like, list(args[k:])), path, i)
            return body(x, p, *args[:k]), torch.zeros((), device=x.device)
        return fn

    for i in range(n):
        lp = C.period_of(layers, path, i)
        if remat == "none":   # aliases, or the modes' grads are not bit-equal
            x = body(x, C.gathered(lp, path, i),
                     *(c.view_as(c) for c in consts))
        else:
            like = tree_util.map(lambda _: None, lp)
            x, _ = checkpointed(fn_of(like, i), x, *consts,
                                *tree_util.leaves(lp))
    return x


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_attn(p, cfg, x):
    B, S, d = x.shape
    q, k, v, mode = C.gqa_qkv(p, cfg, x)
    pos = torch.arange(S, device=x.device)
    out = C.mesh_attention(mode, cfg, q, k, v, pos, pos, causal=False)
    return C.row_linear(p["wo"], out.reshape(B, S, -1),
                        cfg.num_heads * cfg.head_dim)


def _enc_layer(x, lp, cfg):
    h = C.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + _enc_attn(lp["attn"], cfg, h)
    h = C.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + C.mlp_block(lp["mlp"], h, cfg.d_ff, unread=True)


def encode(params, cfg, audio_embeds, *, remat: str = "none"
           ) -> torch.Tensor:
    """(B, F, frontend_dim) -> (B, F, d_model)."""
    a = audio_embeds.to(C.dtype_of(cfg))
    x = C.col_linear(C.gathered(params["frontend_proj"], "frontend_proj"),
                     a, C.model_copy(a), cfg.d_model)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x = _scan(lambda x, lp: _enc_layer(x, lp, cfg), x, params["enc"],
              cfg.encoder_layers, remat, path="enc")
    return C.rmsnorm(C.gathered(params["enc_norm"], "enc_norm"), x,
                     cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_attn(p, cfg, x, enc_kv):
    """Cross-attention of ``x`` to ``enc_kv``, which holds this rank's KV
    heads when the layer's heads are local (:func:`_cross_kv`); the q
    heads as ``models/common.py::head_mode`` gives them to this rank."""
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    mode = C.head_mode(p, cfg, S)
    q = C.col_linear(p["wq"], x, C.model_copy(x), H * hd,
                     keep_block=mode in ("local", "kv")
                     ).reshape(B, S, -1, hd)
    k, v = enc_kv
    T = k.shape[1]
    out = C.mesh_attention(mode, cfg, q, k, v,
                           torch.arange(S, device=x.device),
                           torch.arange(T, device=x.device), causal=False)
    return C.row_linear(p["wo"], out.reshape(B, S, -1), H * hd)


def _dec_layer(lp, cfg, x, enc_kv, *, positions, cache=None):
    h = C.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    sa, _ = C.attention_block(lp["self_attn"], cfg, h, positions=positions,
                              window=None, cache=cache)
    x = x + sa
    h = C.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    x = x + _cross_attn(lp["cross_attn"], cfg, h, enc_kv)
    h = C.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + C.mlp_block(lp["mlp"], h, cfg.d_ff, unread=True)


def _cross_kv(lp, cfg, enc_out):
    """The cross-attention K/V of one decoder layer: this rank's KV heads
    when the layer's heads are local, all of them otherwise."""
    B, T, _ = enc_out.shape
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    p = lp["cross_attn"]
    local, xc = C.heads_local(p, cfg), C.model_copy(enc_out)
    k = C.col_linear(p["wk"], enc_out, xc, Kv * hd, keep_block=local)
    v = C.col_linear(p["wv"], enc_out, xc, Kv * hd, keep_block=local)
    return k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd)


def forward(params, cfg, batch, *, remat: str = "none"):
    """Full enc-dec training forward -> (logits (B,S,V) f32, aux = 0)."""
    enc_out = encode(params, cfg, batch["audio_embeds"], remat=remat)
    x = (C.embed(C.gathered(params["embed"], "embed"), batch["tokens"],
                 cfg.vocab_size) * math.sqrt(cfg.d_model))

    def body(x, lp, enc_out):
        positions = torch.arange(x.shape[1], device=x.device)
        return _dec_layer(lp, cfg, x, _cross_kv(lp, cfg, enc_out),
                          positions=positions)

    x = _scan(body, x, params["dec"], cfg.num_layers, remat, enc_out,
              path="dec")
    logits = _logits(params, cfg, x)
    return logits, torch.zeros((), device=logits.device)


def _logits(params, cfg, x) -> torch.Tensor:
    """f32 logits of the decoder's output, every vocab block gathered."""
    x = C.rmsnorm(C.gathered(params["dec_norm"], "dec_norm"), x,
                  cfg.norm_eps)
    return C.col_linear(C.gathered(params["lm_head"], "lm_head"), x,
                        C.model_copy(x), cfg.vocab_size).float()


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
    kv = [_cross_kv(C.gathered(C.period_of(params["dec"], "dec", i), "dec",
                               i), cfg, enc_out)
          for i in range(cfg.num_layers)]
    cache["cross"] = {"k": torch.stack([k for k, _ in kv]),
                      "v": torch.stack([v for _, v in kv])}
    return cache


def decode_step(params, cfg, cache, tokens, pos):
    """One decoder token (tokens (B,1), pos an int) against the cached
    self/cross KV; the self-attention cache is written in place.  Returns
    (logits (B,1,V) f32, cache)."""
    x = C.embed(C.gathered(params["embed"], "embed"), tokens,
                cfg.vocab_size) * math.sqrt(cfg.d_model)
    positions = C.step_positions(pos, tokens.device)
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    xk, xv = cache["cross"]["k"], cache["cross"]["v"]
    for i in range(cfg.num_layers):
        lp = C.gathered(C.period_of(params["dec"], "dec", i), "dec", i)
        x = _dec_layer(lp, cfg, x, (xk[i], xv[i]),
                       positions=positions,
                       cache={"k": sk[i], "v": sv[i]})
    return _logits(params, cfg, x), cache
