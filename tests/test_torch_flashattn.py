"""The flash-attention kernel K6's plain version and the model's attention
core against the reference, on the CPU.

The same numpy inputs go to ``repro`` and ``repro_torch``.  The port's
``flash_attention_ref`` is held to the reference's ``flash_attention_ref``
and to its Pallas kernel (``flash_attention``, interpret mode on the CPU, as
``tests/test_flashattn.py`` runs it) over that file's own sweep, at its
tolerances: 2e-3 in f32, 3e-2 in bf16.  ``attention_core`` is compared with
the reference's with ``USE_FLASH_ATTN`` off and monkeypatched on (the port
takes its ``_attend`` path on the CPU either way) at 2e-3.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn.ops import flash_attention as r_flash
from repro.kernels.flashattn.ref import flash_attention_ref as r_ref
from repro.models import common as RC
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flashattn.kernel import flash_attention_hopper
from repro_torch.kernels.flashattn.ref import flash_attention_ref as t_ref
from repro_torch.models import common as TC

TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _qkv(B, S, T, H, Kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, Kv, hd)).astype(np.float32),
            rng.standard_normal((B, T, Kv, hd)).astype(np.float32))


def _as(xs, dtype):
    return ([jnp.asarray(x, getattr(jnp, dtype)) for x in xs],
            [torch.tensor(x).to(getattr(torch, dtype)) for x in xs])


# tests/test_flashattn.py's sweep: (B, S, H, Kv, hd, window, cap, dtype).
SWEEP = [
    (2, 128, 4, 2, 64, None, None, "float32"),
    (2, 256, 8, 8, 32, None, None, "float32"),
    (2, 128, 6, 2, 128, None, None, "float32"),
    (2, 192, 2, 1, 64, None, None, "float32"),
    (1, 128, 4, 4, 64, 32, None, "float32"),
    (1, 128, 4, 4, 64, 64, None, "float32"),
    (1, 128, 4, 4, 64, 1024, None, "float32"),
    (1, 128, 4, 2, 64, None, 50.0, "float32"),
    (1, 128, 4, 4, 64, None, None, "bfloat16"),
    (1, 96, 2, 1, 64, None, None, "float32"),         # unaligned: 96
]


@pytest.mark.parametrize("B,S,H,Kv,hd,window,cap,dtype", SWEEP)
def test_plain_version_matches_reference(B, S, H, Kv, hd, window, cap,
                                         dtype):
    (jq, jk, jv), (tq, tk, tv) = _as(_qkv(B, S, S, H, Kv, hd), dtype)
    got = t_ref(tq, tk, tv, window=window, cap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    want = np.asarray(r_ref(jq, jk, jv, window=window, cap=cap), np.float32)
    np.testing.assert_allclose(got, want, atol=TOL[dtype])
    pallas = np.asarray(r_flash(jq, jk, jv, window=window, cap=cap, bq=64,
                                bk=64), np.float32)
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 32])
def test_plain_version_matches_reference_noncausal(window):
    (jq, jk, jv), (tq, tk, tv) = _as(_qkv(1, 64, 80, 4, 2, 64), "float32")
    got = t_ref(tq, tk, tv, causal=False, window=window).numpy()
    want = np.asarray(r_ref(jq, jk, jv, causal=False, window=window))
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("flash_on", [False, True])
@pytest.mark.parametrize("window,cap", [(None, None), (16, 50.0)])
def test_attention_core_matches_reference(monkeypatch, flash_on, window,
                                          cap):
    """The reference with USE_FLASH_ATTN on runs its Pallas kernel (interpret
    mode); the port on the CPU takes _attend either way and launches no
    kernel."""
    monkeypatch.setattr(RC, "USE_FLASH_ATTN", flash_on)
    (jq, jk, jv), (tq, tk, tv) = _as(_qkv(2, 64, 64, 4, 2, 64, seed=3),
                                     "float32")
    pos = np.arange(64)
    want = RC.attention_core(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                             causal=True, window=window, cap=cap)
    before = flash_attention_hopper.launches
    got = TC.attention_core(tq, tk, tv, torch.tensor(pos), torch.tensor(pos),
                            causal=True, window=window, cap=cap)
    assert flash_attention_hopper.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_attention_core_chunks_long_queries():
    """Sq a multiple of the query chunk: the chunked path equals one
    unchunked _attend (the reference chunks the same way)."""
    (_, (tq, tk, tv)) = _as(_qkv(1, 64, 64, 2, 1, 64, seed=4), "float32")
    pos = torch.arange(64)
    chunked = TC.attention_core(tq, tk, tv, pos, pos, chunk=16)
    whole = TC.attention_core(tq, tk, tv, pos, pos, chunk=64)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


def test_cpu_wrapper_takes_the_plain_version():
    (_, (tq, tk, tv)) = _as(_qkv(1, 40, 40, 4, 2, 64, seed=5), "float32")
    before = flash_attention_hopper.launches
    got = tops.flash_attention(tq, tk, tv, window=8, cap=30.0)
    assert flash_attention_hopper.launches == before
    assert torch.equal(got, t_ref(tq, tk, tv, window=8, cap=30.0))


@pytest.mark.parametrize("case,match", [
    ("hd", "head_dim"), ("gqa", "H % Kv"), ("dtype", "takes"),
    ("mixed", "dtypes differ"), ("window", "window"), ("cap", "cap"),
    ("rank", "4-D"), ("batch", "batch or head_dim"),
])
def test_wrapper_checks_its_inputs(case, match):
    (_, (q, k, v)) = _as(_qkv(2, 16, 16, 4, 2, 64), "float32")
    kw = {}
    if case == "hd":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif case == "gqa":
        q = q[:, :, :3]
    elif case == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        k = k.half()
    elif case == "window":
        kw["window"] = 0
    elif case == "cap":
        kw["cap"] = 0.0
    elif case == "rank":
        q = q[0]
    elif case == "batch":
        k, v = k[:1], v[:1]
    with pytest.raises(ValueError, match=match):
        flash_attention_hopper(q, k, v, **kw)
