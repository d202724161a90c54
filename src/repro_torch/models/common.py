"""Shared model components, a port of ``repro/models/common.py``: norms,
embeddings, RoPE, query-chunked GQA attention with sliding windows and
softcaps, MLA (multi-head latent attention) with its latent cache, GLU MLPs,
and the ring and paged KV caches.

Parameters are plain nested dicts of tensors in the reference's layout:
linear ``w`` is (d_in, d_out), q/k/v are (B, S, H, hd).  ``init_*`` take a
``torch.Generator`` (on the device the parameters go to) and ``lead``, the
leading period axis of the stacked layout (``models/stack.py``), and draw in
the parameter dtype, so a stacked bf16 weight never has an f32 transient.

Three differences from the reference, each forced by PyTorch:
- JAX's ``einsum(..., preferred_element_type=f32)`` keeps f32 scores from
  bf16 operands; a bf16 ``torch.einsum`` would round them to bf16.  The
  attention products here upcast their operands to f32 first (products of
  bf16 values are exact in f32), and round p to v's dtype before upcasting
  it again, where the reference feeds ``p.astype(v.dtype)`` to the product.
- The caches are updated in place (slice assignment on the ring cache,
  ``index_put_`` on the block pool) and returned, where the reference
  returns updated copies; a cache passed in is the cache that comes back.
- Serving's prefill calls ``attention_core`` with ``flash=True``: on a CUDA
  tensor it sends the reference's flash-attention case (causal
  self-attention, Sq == T > 1) to the flash-attention kernel, the choice
  ``REPRO_FLASH_ATTN=1`` makes in the reference.  The kernel has no
  backward, as the reference's has none, so training (the cacheless
  ``attention_block``), every other call and every call on the CPU take
  ``_attend``, the reference's default.

On a mesh (``dist/mesh.py::use_mesh`` over a world) the layers of every
family with a ``cfg`` compute tensor-parallel on the blocks that
``dist/sharding.py::tree_pspecs`` gives this rank, which they read off the
leaves' shapes: a column-parallel leaf (``wq wk wv wi wg wkv_a wk_rope
wk_b wv_b lm_head in_proj fc1`` and the unnamed ``frontend_proj``) cut on
its output features gives this rank's block of the output, a row-parallel
``wo``/``out_proj``/``fc2`` cut on its input features takes the block and
its partial output is summed over the model axes (``dist/collectives.py``'s
Megatron operators), and the vocab-sharded ``table`` is looked up on this
rank's rows and summed.  Attention (the decoders', whisper's encoder, self-
and cross-attention) runs on this rank's heads when every q and KV column
block falls on head boundaries (``H % tp == 0`` and ``Kv % tp == 0``, so
every GQA group stays whole); otherwise the blocks are gathered and every
rank attends over all heads, which gives the values of the reference's
padded-heads branch.  The Mamba2 block runs on this rank's SSD heads
(``models/ssm.py``).  A whole leaf (``tree_pspecs`` replicates a dim that
does not divide) computes whole.  A tensor that every model rank holds
whole and each rank uses a part of (a per-head leaf such as ``A_log``, a
gathered projection) goes through ``copy_to_model``, so that its
gradient is the sum of the parts'.

With the residual stream sharded over the sequence (the ambient's
``seq_sharded``, set by ``models/stack.py`` under ``SEQ_SHARD``),
:func:`seq_enter` gathers a layer's normed input along the sequence,
:func:`row_linear` reduce-scatters its partial output along the sequence
instead of summing it, :func:`seq_exit` cuts an output that came out
whole (a whole leaf's, the MoE's) to this rank's block, and
:func:`seq_norm` sums the stream norms' scale gradients over the ranks'
positions.

:func:`linear` also serves the ``"dots"`` remat policy of
``models/stack.py``: inside :func:`record_dots` it keeps each product's
output, and inside :func:`replay_dots` it hands the kept outputs back in the
same order, with the product's gradient, instead of computing them again.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll
from repro_torch.dist.mesh import ambient, ambient_as, model_axes

# Query-chunk length for attention: bounds the live (B,H,qc,T) score tensor.
ATTN_QUERY_CHUNK = 1024


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Param initializers
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                lead: tuple = ()) -> dict:
    w = torch.randn(lead + (d_in, d_out), generator=gen, dtype=dtype,
                    device=gen.device)
    return {"w": w.mul_(1.0 / math.sqrt(d_in))}


def init_norm(d: int, dtype, lead: tuple = (), device=None) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    t = torch.randn((vocab, d), generator=gen, dtype=dtype, device=gen.device)
    return {"table": t.mul_(0.02)}


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

_TAPE = threading.local()


@contextlib.contextmanager
def record_dots():
    """Collect the output of every :func:`linear` run inside; yields the
    list they are appended to, in call order."""
    prev = getattr(_TAPE, "state", None)
    tape: list = []
    _TAPE.state = ("record", tape)
    try:
        yield tape
    finally:
        _TAPE.state = prev


@contextlib.contextmanager
def replay_dots(saved):
    """Inside, each :func:`linear` returns the next of ``saved`` (outputs
    of :func:`record_dots` over the same code) with its product's
    gradient, instead of multiplying again."""
    prev = getattr(_TAPE, "state", None)
    _TAPE.state = ("replay", list(saved))
    try:
        yield
    finally:
        _TAPE.state = prev


class _SavedProduct(torch.autograd.Function):
    """``x @ w`` whose forward value is given (the kept output): the
    backward is the product's, from the recomputed ``x`` and ``w``."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.transpose(-1, -2)
        gw = (x.reshape(-1, x.shape[-1]).transpose(0, 1)
              @ g.reshape(-1, g.shape[-1]))
        return gx, gw, None


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    state = getattr(_TAPE, "state", None)
    if state is None:
        return x @ p["w"]
    mode, tape = state
    if mode == "replay":
        return _SavedProduct.apply(x, p["w"], tape.pop(0))
    y = x @ p["w"]
    tape.append(y)
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def embed(p: dict, tokens: torch.Tensor, vocab: Optional[int] = None
          ) -> torch.Tensor:
    """Rows of ``p["table"]``.  With ``vocab`` (the whole row count) a
    table cut to this rank's rows looks up the tokens that fall in them,
    zeroes the others and sums over the model axes."""
    table = p["table"]
    if vocab is None or table.shape[0] == vocab:
        return table[tokens]
    axes = block_axes()
    rows = table.shape[0]
    local = tokens - coll.worker_slice_index(axes) * rows
    mine = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * mine[..., None].to(table.dtype)
    return coll.reduce_from_model(out, axes)


# ---------------------------------------------------------------------------
# Tensor-parallel projections
# ---------------------------------------------------------------------------

def block_axes():
    """The model axes a parameter block was cut over: the ambient world
    mesh's (``dist/mesh.py::use_mesh``)."""
    axes = model_axes()
    if not axes:
        raise RuntimeError("a model-sharded parameter block reached a layer "
                           "outside use_mesh of a world mesh")
    return axes


def is_block(p: dict, n: int, dim: int = -1) -> bool:
    """Whether the linear leaf ``p`` holds a block of its ``n`` whole
    features on ``dim`` (-1: output, -2: input)."""
    return p["w"].shape[dim] != n


def col_linear(p: dict, x, xc, n: int, *, keep_block: bool = False):
    """``x @ w`` of a column-parallel leaf of ``n`` whole output features.
    A block takes ``xc`` (``x`` through ``copy_to_model``) and gives this
    rank's block of the output, gathered over the model axes unless
    ``keep_block``; a whole leaf takes ``x``."""
    if not is_block(p, n):
        return linear(p, x)
    y = linear(p, xc)
    return y if keep_block else coll.gather_from_model(y, block_axes(), -1)


def row_linear(p: dict, h, n: int):
    """``h @ w`` of a row-parallel leaf of ``n`` whole input features.  A
    block sums its partial output over the model axes (with the sequence
    sharded, reduce-scatters it along the sequence, dim -2): ``h`` is
    this rank's block of the input, or the whole input, of which it takes
    this rank's columns (through ``copy_to_model``)."""
    if not is_block(p, n, -2):
        return linear(p, h)
    axes = block_axes()
    if h.shape[-1] == n:
        rows = p["w"].shape[-2]
        i = coll.worker_slice_index(axes)
        h = coll.copy_to_model(h, axes)[..., i * rows:(i + 1) * rows]
    if seq_axes():
        return coll.reduce_scatter_to_model(linear(p, h), axes, -2)
    return coll.reduce_from_model(linear(p, h), axes)


def model_copy(x):
    """``x`` through ``copy_to_model`` on a mesh, ``x`` itself off one."""
    return coll.copy_to_model(x, model_axes())


def heads_local(p: dict, cfg) -> bool:
    """Whether a GQA layer's ``wq``/``wk``/``wv`` are all blocks that
    fall on head boundaries, so that it attends on this rank's heads."""
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    blocks = [is_block(p[n], w) for n, w in
              (("wq", H * hd), ("wk", Kv * hd), ("wv", Kv * hd))]
    if not all(blocks):
        return False
    tp = coll.axis_size(block_axes())
    return H % tp == 0 and Kv % tp == 0


# ---------------------------------------------------------------------------
# The sequence-sharded residual stream
# ---------------------------------------------------------------------------

def seq_axes() -> tuple:
    """The model axes the residual stream's sequence is sharded over, ()
    when it is whole."""
    am = ambient()
    return model_axes() if am is not None and am.seq_sharded else ()


def seq_enter(x: torch.Tensor) -> torch.Tensor:
    """A layer's normed input gathered along the sequence (dim 1) when the
    stream is sharded.  Backward: this rank's block of the gradient, which
    the layer's ``copy_to_model`` has summed over the model axes where the
    ranks use it apart (together, a reduce-scatter)."""
    axes = seq_axes()
    return coll.gather_from_model(x, axes, 1) if axes else x


def seq_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rmsnorm` of the stream: on a sequence-sharded stream each
    rank normalizes its own positions, so the scale goes through
    ``copy_to_model`` (its gradient summed over the model axes, as
    Megatron-SP all-reduces its norms' gradients)."""
    axes = seq_axes()
    if axes:
        p = {"scale": coll.copy_to_model(p["scale"], axes)}
    return rmsnorm(p, x, eps)


def seq_exit(y: torch.Tensor, n: int) -> torch.Tensor:
    """A layer's output as the stream's block of ``n`` positions: an
    output that came out whole (every model rank computing it alike) cut
    to this rank's block (backward: the blocks' gradients gathered); a
    reduce-scattered one as it is."""
    axes = seq_axes()
    if not axes or y.shape[1] == n:
        return y
    return coll.scatter_to_model(y, axes, 1)


@contextlib.contextmanager
def whole_sequence():
    """The code inside computes on the whole sequence and sums its partial
    outputs whole, even on a sequence-sharded stream (the MoE FFN, which
    dispatches flat tokens)."""
    am = ambient()
    if am is None or not am.seq_sharded:
        yield
        return
    with ambient_as(dataclasses.replace(am, seq_sharded=False)):
        yield


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                         # broadcast heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core (GQA + sliding window + softcap), query-chunked
# ---------------------------------------------------------------------------

def _attend(q, k, v, q_pos, k_pos, *, causal, window, cap, scale):
    """q: (B,Sq,H,hd) k/v: (B,T,Kv,hd); q_pos (Sq,), k_pos (T,) (-1=invalid)."""
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    qg = q.reshape(B, Sq, Kv, rep, hd)
    s = torch.einsum("bqkrh,btkh->bkrqt", qg.float(), k.float()) * scale
    s = softcap(s, cap)
    mask = (k_pos >= 0)[None, :]                       # (1, T) validity
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)                       # f32 softmax
    p = torch.where(torch.isnan(p), 0.0, p)            # fully-masked rows
    out = torch.einsum("bkrqt,btkh->bqkrh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def attention_core(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                   cap=None, scale=None, chunk=ATTN_QUERY_CHUNK, flash=False):
    """Query-chunked masked attention; see _attend for shapes.  ``flash``:
    the caller is a serving prefill, of which no gradient is taken."""
    B, Sq, H, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if (flash and q.is_cuda and causal and Sq > 1 and Sq == k.shape[1]
            and q.is_floating_point()):
        # self-attention prefill (q_pos == k_pos == arange)
        from repro_torch.kernels.ops import flash_attention
        return flash_attention(q, k, v, causal=True, window=window, cap=cap,
                               scale=scale)
    if Sq <= chunk or Sq % chunk != 0:
        return _attend(q, k, v, q_pos, k_pos, causal=causal, window=window,
                       cap=cap, scale=scale)
    return torch.cat([
        _attend(q[:, i:i + chunk], k, v, q_pos[i:i + chunk], k_pos,
                causal=causal, window=window, cap=cap, scale=scale)
        for i in range(0, Sq, chunk)], dim=1)


# ---------------------------------------------------------------------------
# GQA attention block with ring-buffer KV cache
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    dt = dtype_of(cfg)
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": init_linear(gen, d, H * hd, dt, lead),
        "wk": init_linear(gen, d, Kv * hd, dt, lead),
        "wv": init_linear(gen, d, Kv * hd, dt, lead),
        "wo": init_linear(gen, H * hd, d, dt, lead),
    }


def init_attn_cache(cfg, batch: int, max_len: int, window: Optional[int],
                    lead: tuple = (), device=None) -> dict:
    dt = dtype_of(cfg)
    size = min(window, max_len) if window else max_len
    shape = lead + (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_positions(size: int, pos: int, window: Optional[int],
                     device=None) -> torch.Tensor:
    """Global position stored in each ring slot at decode position ``pos``.

    Un-windowed caches are absolute: slot s holds position s (valid iff
    s <= pos).  Windowed ring buffers of size W: slot s holds the largest
    p <= pos with p ≡ s (mod W); never-written slots map to -1 (invalid).
    """
    s = torch.arange(size, device=device)
    if window is None:
        return torch.where(s <= pos, s, -1)
    p = pos - ((pos - s) % size)
    return torch.where(p >= 0, p, -1)


def gqa_qkv(p, cfg, x):
    """q, k, v of a GQA layer as (B, S, heads, hd), with the head counts:
    this rank's heads when every block is head-aligned (and the k/v of a
    sharded cache), all of them otherwise (blocks gathered)."""
    B, S, d = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xc = model_copy(x)
    local = heads_local(p, cfg)
    q = col_linear(p["wq"], x, xc, H * hd, keep_block=local)
    k = col_linear(p["wk"], x, xc, Kv * hd, keep_block=local)
    v = col_linear(p["wv"], x, xc, Kv * hd, keep_block=local)
    return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


def attention_block(p, cfg, x, *, positions, window, cache=None):
    """x: (B,S,d).  Training (no cache) when cache is None; cached otherwise:
    decode (S==1, positions (1,)) or batched prefill (S==S0 contiguous
    positions, S0 <= the layer's ring size — engine-gated).  The cache is
    written in place and returned.  On a mesh the cache holds this rank's
    KV heads when they are sharded (``cache_pspec``)."""
    B, S, d = x.shape
    q, k, v = gqa_qkv(p, cfg, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = attention_core(q, k, v, positions, positions, causal=True,
                             window=window, cap=cfg.attn_logit_softcap)
    else:
        size = cache["k"].shape[1]
        start = int(positions[0])           # write offset (decode: the step)
        last = int(positions[-1])           # newest position now in the cache
        slot = min(start % size, size - S)  # dynamic_update_slice's clamp
        cache["k"][:, slot:slot + S] = k
        cache["v"][:, slot:slot + S] = v
        k_pos = _cache_positions(size, last, window, x.device)
        # A batched prefill from position 0 wrote slots 0..S-1, and every
        # other slot is still invalid (masked): attending over the written
        # slots alone is the same softmax, and a self-attention the
        # flash-attention kernel takes (Sq == T).
        T = S if start == 0 and S > 1 else size
        out = attention_core(q, cache["k"][:, :T], cache["v"][:, :T],
                             positions, k_pos[:T], causal=True,
                             window=window, cap=cfg.attn_logit_softcap,
                             flash=True)
    H, hd = cfg.num_heads, cfg.head_dim
    return row_linear(p["wo"], out.reshape(B, S, -1), H * hd), cache


# ---------------------------------------------------------------------------
# Paged KV cache (DESIGN.md §11)
# ---------------------------------------------------------------------------
# One global pool of fixed-size blocks per layer; requests own disjoint block
# lists via per-request block tables (B, max_blocks).  Block 0 is the
# reserved null/trash block: inactive batch slots carry an all-zero table row
# and scatter their k/v there — its contents are finite garbage that active
# requests never attend to.

def init_paged_kv(cfg, num_blocks: int, block_tokens: int, lead: tuple = (),
                  device=None) -> dict:
    dt = dtype_of(cfg)
    shape = lead + (num_blocks, block_tokens, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _attend_paged(q, k, v, pos, *, cap, scale=None):
    """Decode attention with per-request lengths.  q: (B,1,H,hd); k/v:
    (B,T,Kv,hd) gathered per-request views; pos: (B,) newest position of
    each request.  The contractions, f32 softmax and NaN guard of
    :func:`_attend`, with a per-request (B,T) validity mask."""
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, Sq, Kv, rep, hd)
    s = torch.einsum("bqkrh,btkh->bkrqt", qg.float(), k.float()) * scale
    s = softcap(s, cap)
    mask = torch.arange(T, device=q.device)[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)                       # f32 softmax
    p = torch.where(torch.isnan(p), 0.0, p)            # fully-masked rows
    out = torch.einsum("bkrqt,btkh->bqkrh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def attention_block_paged(p, cfg, x, *, positions, block_tables, cache):
    """One paged decode step.  x: (B,1,d); positions: (B,) int64 write
    position; block_tables: (B, max_blocks) int64; cache: the layer's block
    pool {"k","v"}: (N, bt, Kv, hd).  Writes the new k/v at
    (table[pos//bt], pos%bt) in place, then attends over the gathered
    per-request view.  Global (un-windowed) layers only."""
    B, S, d = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, Kv, hd)
    v = linear(p["wv"], x).reshape(B, S, Kv, hd)
    q = rope(q, positions[:, None], cfg.rope_theta)
    k = rope(k, positions[:, None], cfg.rope_theta)

    bt = cache["k"].shape[1]
    blk = torch.gather(block_tables, 1, (positions // bt)[:, None])[:, 0]
    off = positions % bt
    cache["k"][blk, off] = k[:, 0]
    cache["v"][blk, off] = v[:, 0]
    T = block_tables.shape[1] * bt
    keys = cache["k"][block_tables].reshape(B, T, Kv, hd)
    vals = cache["v"][block_tables].reshape(B, T, Kv, hd)
    out = _attend_paged(q, keys, vals, positions, cap=cfg.attn_logit_softcap)
    return linear(p["wo"], out.reshape(B, S, H * hd)), cache


def attention_block_prefill_paged(p, cfg, x, *, positions, block_tables,
                                  cache):
    """Batched paged prefill.  x: (B,S0,d) whole prompts aligned at position
    0; positions: (S0,) = arange(S0).  Ordinary causal self-attention over
    the prompt (no cache read), with the computed k/v written into the block
    pool in place so later paged decode steps see them."""
    B, S, d = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, Kv, hd)
    v = linear(p["wv"], x).reshape(B, S, Kv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = attention_core(q, k, v, positions, positions, causal=True,
                         window=None, cap=cfg.attn_logit_softcap, flash=True)

    bt = cache["k"].shape[1]
    blk = block_tables[:, positions // bt]             # (B, S0)
    off = (positions % bt).expand(B, S)
    cache["k"][blk, off] = k
    cache["v"][blk, off] = v
    return linear(p["wo"], out.reshape(B, S, H * hd)), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2) with latent KV cache
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    dt = dtype_of(cfg)
    d, H = cfg.d_model, cfg.num_heads
    nope, rdim, vdim, rank = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
    return {
        "wq": init_linear(gen, d, H * (nope + rdim), dt, lead),
        "wkv_a": init_linear(gen, d, rank, dt, lead),        # latent down-proj
        "wk_rope": init_linear(gen, d, rdim, dt, lead),      # shared rope key
        "wk_b": init_linear(gen, rank, H * nope, dt, lead),  # latent -> keys
        "wv_b": init_linear(gen, rank, H * vdim, dt, lead),  # latent -> values
        "wo": init_linear(gen, H * vdim, d, dt, lead),
    }


def init_mla_cache(cfg, batch: int, max_len: int, lead: tuple = (),
                   device=None) -> dict:
    dt = dtype_of(cfg)
    return {
        "ckv": torch.zeros(lead + (batch, max_len, cfg.kv_lora_rank),
                           dtype=dt, device=device),
        "krope": torch.zeros(lead + (batch, max_len, cfg.qk_rope_head_dim),
                             dtype=dt, device=device),
    }


def _mla_attend(cfg, q_nope, q_rope, k_nope, v, krope, q_pos, k_pos):
    """q_nope (B,Sq,H,n), q_rope (B,Sq,H,r), k_nope (B,T,H,n), v (B,T,H,vd),
    krope (B,T,r); f32 scores and softmax, as :func:`_attend`."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    s = (torch.einsum("bqhn,bthn->bhqt", q_nope.float(), k_nope.float())
         + torch.einsum("bqhr,btr->bhqt", q_rope.float(), krope.float())
         ) * scale
    mask = (k_pos[None, :] >= 0) & (k_pos[None, :] <= q_pos[:, None])
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)            # fully-masked rows
    out = torch.einsum("bhqt,bthv->bqhv", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _mla_attend_chunked(p, cfg, q_nope, q_rope, ckv, krope, q_pos, k_pos,
                        chunk=ATTN_QUERY_CHUNK):
    """q_nope/q_rope hold this rank's heads or all of them; ``wk_b`` and
    ``wv_b`` expand the (whole) latent to the same heads."""
    B, Sq, Hq = q_nope.shape[:3]
    T = ckv.shape[1]
    H = cfg.num_heads
    nope, vdim = cfg.qk_nope_head_dim, cfg.v_head_dim
    local = Hq != H
    ckv_c = model_copy(ckv)
    if local:                   # a replicated operand of this rank's heads
        krope = model_copy(krope)
    # Expand latent -> per-head keys/values once (chunk-invariant); only the
    # (B,H,chunk,T) score tensor is made again per query chunk.
    k_nope = col_linear(p["wk_b"], ckv, ckv_c, H * nope,
                        keep_block=local).reshape(B, T, Hq, nope)
    v = col_linear(p["wv_b"], ckv, ckv_c, H * vdim,
                   keep_block=local).reshape(B, T, Hq, vdim)
    if Sq <= chunk or Sq % chunk != 0:
        return _mla_attend(cfg, q_nope, q_rope, k_nope, v, krope, q_pos,
                           k_pos)
    return torch.cat([
        _mla_attend(cfg, q_nope[:, i:i + chunk], q_rope[:, i:i + chunk],
                    k_nope, v, krope, q_pos[i:i + chunk], k_pos)
        for i in range(0, Sq, chunk)], dim=1)


def mla_block(p, cfg, x, *, positions, cache=None):
    """x: (B,S,d).  Training when cache is None; otherwise decode or a
    batched prefill from position 0, as :func:`attention_block`.  The latent
    cache (``ckv`` (B,T,rank), ``krope`` (B,T,rope)) is written in place
    and returned.  MLA layers are global (no window).  On a mesh the
    latent and the shared rope key are gathered whole (``wkv_a`` and
    ``wk_rope`` cut them mid-vector), so every rank caches them whole."""
    B, S, d = x.shape
    H = cfg.num_heads
    nope, rdim, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    xc = model_copy(x)
    blocks = [is_block(p["wq"], H * (nope + rdim)),
              is_block(p["wk_b"], H * nope), is_block(p["wv_b"], H * vdim)]
    tp = coll.axis_size(block_axes()) if any(blocks) else 1
    local = all(blocks) and H % tp == 0
    q = col_linear(p["wq"], x, xc, H * (nope + rdim), keep_block=local)
    q = q.reshape(B, S, -1, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv_new = col_linear(p["wkv_a"], x, xc, cfg.kv_lora_rank)  # (B,S,rank)
    krope_new = rope(col_linear(p["wk_rope"], x, xc, rdim)[:, :, None],
                     positions, cfg.rope_theta)[:, :, 0]       # (B,S,rdim)

    if cache is None:
        out = _mla_attend_chunked(p, cfg, q_nope, q_rope, ckv_new, krope_new,
                                  positions, positions)
    else:
        T = cache["ckv"].shape[1]
        last = int(positions[-1])                   # newest cached position
        start = min(int(positions[0]), T - S)       # dynamic_update_slice's
        cache["ckv"][:, start:start + S] = ckv_new  # clamp
        cache["krope"][:, start:start + S] = krope_new
        t = torch.arange(T, device=x.device)
        k_pos = torch.where(t <= last, t, -1)
        out = _mla_attend_chunked(p, cfg, q_nope, q_rope, cache["ckv"],
                                  cache["krope"], positions, k_pos)
    return row_linear(p["wo"], out.reshape(B, S, -1), H * vdim), cache


# ---------------------------------------------------------------------------
# Dense GLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_ff: Optional[int] = None,
             lead: tuple = ()) -> dict:
    dt = dtype_of(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": init_linear(gen, d, f, dt, lead),
        "wg": init_linear(gen, d, f, dt, lead),
        "wo": init_linear(gen, f, d, dt, lead),
    }


def mlp_block(p, x: torch.Tensor, d_ff: Optional[int] = None
              ) -> torch.Tensor:
    """The GLU MLP; given its whole hidden width ``d_ff``, leaves cut on it
    compute tensor-parallel (``wi``/``wg`` column, ``wo`` row)."""
    if d_ff is None or not is_block(p["wi"], d_ff):
        return linear(p["wo"], F.silu(linear(p["wg"], x))
                      * linear(p["wi"], x))
    xc = model_copy(x)
    h = F.silu(linear(p["wg"], xc)) * linear(p["wi"], xc)
    return row_linear(p["wo"], h, d_ff)
