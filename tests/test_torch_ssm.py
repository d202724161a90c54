"""The port's Mamba2 SSD (``repro_torch.models.ssm``) against the reference
on the CPU, in f32.

The same numpy inputs go to both packages.  The chunked SSD agrees with the
reference's within atol 1e-5 (outputs and final states), with its own
step-by-step recurrence within 1e-4 (the reference's own test of the
duality), and its gradients under ``torch.func.grad`` are finite and within
atol 1e-4 + rtol 1e-3 of ``jax.grad``'s (XLA and PyTorch sum in other
orders).  ``mamba_block``'s forward and its S == 1 decode step agree with
the reference's within atol 1e-5 (the decode caches within the recurrence
test's 1e-4), with one head's softplus input past 20, where torch's
``softplus`` would switch to the identity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_arch
from repro.models import ssm as rssm
from repro_torch.configs import get_arch as t_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ssm as tssm

SSD_SHAPE = (2, 32, 3, 4, 8)          # b, S, h, p, n (the reference's test)


def _ssd_inputs(S=32, seed=0, with_state=False, decay=1.0):
    b, _, h, p, n = SSD_SHAPE
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, h, p)).astype(np.float32)
    dA = -decay * np.logaddexp(rng.standard_normal((b, S, h)), 0)
    dA = dA.astype(np.float32)
    B = rng.standard_normal((b, S, n)).astype(np.float32)
    C = rng.standard_normal((b, S, n)).astype(np.float32)
    out = [x, dA, B, C]
    if with_state:
        out.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    return out


def _recurrence(x, dA, B, C, state=None):
    """The port's step-by-step recurrence of the SSD."""
    b, S, h, p = x.shape
    if state is None:
        state = torch.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(S):
        state = (torch.exp(dA[:, t])[..., None, None] * state
                 + torch.einsum("bhp,bn->bhpn", x[:, t], B[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("S,with_state", [(32, False), (32, True),
                                          (12, False)])
def test_ssd_chunked_matches_reference(S, with_state):
    """Chunk 8: four chunks at S = 32 (the cross-chunk recurrence runs),
    with and without an initial state; S = 12 is not a multiple of 8 and
    runs as one degenerate chunk in both packages."""
    arrs = _ssd_inputs(S, seed=S, with_state=with_state)
    r_y, r_state = jax.jit(lambda *a: rssm.ssd_chunked(
        *a[:4], chunk=8, init_state=a[4] if with_state else None))(
        *map(jnp.asarray, arrs))
    t_y, t_state = tssm.ssd_chunked(
        *map(torch.tensor, arrs[:4]), chunk=8,
        init_state=torch.tensor(arrs[4]) if with_state else None)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(r_y), atol=1e-5)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(r_state),
                               atol=1e-5)
    rec_y, rec_state = _recurrence(
        *map(torch.tensor, arrs[:4]),
        state=torch.tensor(arrs[4]) if with_state else None)
    torch.testing.assert_close(t_y, rec_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(t_state, rec_state, atol=1e-4, rtol=1e-4)


def test_degenerate_chunk_is_one_chunk():
    """S % chunk != 0 -> one chunk of S: the same numbers as chunk = S."""
    arrs = [torch.tensor(a) for a in _ssd_inputs(12, seed=4)]
    y8, s8 = tssm.ssd_chunked(*arrs, chunk=8)
    y12, s12 = tssm.ssd_chunked(*arrs, chunk=12)
    torch.testing.assert_close(y8, y12, rtol=0, atol=0)
    torch.testing.assert_close(s8, s12, rtol=0, atol=0)


@pytest.mark.parametrize("decay", [1.0, 20.0])
def test_ssd_gradients_match_jax_grad(decay):
    """d/d(x, dA, B, C, state) of a weighted sum of the outputs and the
    final state: finite and equal to the reference's.  At decay 20 a
    chunk's decays sum past f32's exp range, so the entries above the
    diagonal of ``_segsum`` would overflow were the mask applied after the
    exp (0 * inf = NaN in the backward); masked first, they give zero
    gradients."""
    arrs = _ssd_inputs(32, seed=5, with_state=True, decay=decay)
    rng = np.random.default_rng(6)
    wy = rng.standard_normal(arrs[0].shape).astype(np.float32)
    ws = rng.standard_normal(arrs[4].shape).astype(np.float32)

    def r_obj(x, dA, B, C, s):
        y, st = rssm.ssd_chunked(x, dA, B, C, chunk=8, init_state=s)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    def t_obj(x, dA, B, C, s):
        y, st = tssm.ssd_chunked(x, dA, B, C, chunk=8, init_state=s)
        return torch.sum(y * torch.tensor(wy)) + torch.sum(
            st * torch.tensor(ws))

    want = jax.jit(jax.grad(r_obj, argnums=tuple(range(5))))(
        *map(jnp.asarray, arrs))
    got = torch.func.grad(t_obj, argnums=tuple(range(5)))(
        *map(torch.tensor, arrs))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-3)


@pytest.fixture(scope="module")
def block():
    """The reference's mamba2-reduced block parameters (one head's dt_bias
    at 25, so its softplus input passes 20), and the port's copy."""
    cfg = r_arch("mamba2-2.7b-reduced")
    rp = jax.tree.map(np.asarray, rssm.init_mamba(jax.random.PRNGKey(1),
                                                  cfg))
    rp["dt_bias"] = rp["dt_bias"].copy()
    rp["dt_bias"][0] = 25.0
    return cfg, rp, lm_params_from_numpy(rp)


def test_mamba_block_forward_and_decode_match_reference(block):
    cfg, rp, tp = block
    tcfg = t_arch("mamba2-2.7b-reduced")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    r_block = jax.jit(lambda p, x, c: rssm.mamba_block(p, cfg, x, cache=c))
    r_out, _ = r_block(rp, jnp.asarray(x), None)
    t_out, _ = tssm.mamba_block(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), atol=1e-5)
    # the softplus input of head 0 passes 20 on every token
    d_inner, nheads = tssm._dims(tcfg)
    dt_raw = (torch.tensor(x) @ tp["in_proj"]["w"])[..., -nheads:]
    assert bool((dt_raw[..., 0] + tp["dt_bias"][0] > 20).all())

    r_cache = rssm.init_mamba_cache(cfg, 2)
    t_cache = tssm.init_mamba_cache(tcfg, 2)
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        r_o, r_cache = r_block(rp, jnp.asarray(xt), r_cache)
        t_o, same = tssm.mamba_block(tp, tcfg, torch.tensor(xt),
                                     cache=t_cache)
        assert same is t_cache                      # written in place
        np.testing.assert_allclose(t_o.numpy(), np.asarray(r_o), atol=1e-5)
        # the caches carry 16 steps of rounding (fused multiply-adds in
        # XLA): the recurrence test's 1e-4
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(t_cache[k].numpy(),
                                       np.asarray(r_cache[k]), atol=1e-4,
                                       rtol=1e-4)
    # decode == the chunked forward
    np.testing.assert_allclose(t_o.numpy()[:, 0], t_out.numpy()[:, -1],
                               atol=2e-3, rtol=1e-3)


def test_mamba_params_and_cache_dtypes_in_bf16():
    cfg = dataclasses.replace(t_arch("mamba2-2.7b-reduced"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p = tssm.init_mamba(torch.Generator().manual_seed(0), cfg, lead=(3,))
    for k in ("dt_bias", "A_log", "D"):
        assert p[k].dtype == torch.float32 and p[k].shape[0] == 3
    for k in ("conv_w", "conv_b"):
        assert p[k].dtype == torch.bfloat16
    assert p["norm"]["scale"].dtype == torch.bfloat16
    # A_log = log(1 + 15 u), u ~ U[0, 1)
    assert 0.0 <= float(p["A_log"].min()) and float(p["A_log"].max()) < 2.78
    cache = tssm.init_mamba_cache(cfg, 2)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    assert cache["ssm"].shape == (2, 2 * cfg.d_model // cfg.ssm_head_dim,
                                  cfg.ssm_head_dim, cfg.ssm_state)
