"""The port's LM (``repro_torch.models``) against the reference on the CPU.

Parameters come from the reference's ``init`` through
``lm_params_from_numpy``; the same numpy tokens go to both packages.  At f32
the logits agree within atol 1e-4 (XLA and PyTorch accumulate the matmuls in
other orders; the logits are O(1-5)), losses within rtol 1e-5, greedy tokens
exactly.  The port's paged path is held to its dense path within atol 1e-5:
the two sum in other orders (ROADMAP queue 3: the reference's own paged and
dense paths differ by up to 1.9e-6).  A bf16 variant is held within atol 0.1
on logits up to ~4.3: bf16 keeps 8 significant bits and the two frameworks
round the matmul outputs at other points (max 0.047 measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_arch
from repro.models import build_model as r_build
from repro_torch import tree as tree_util
from repro_torch.configs import get_arch as t_arch, list_archs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import PagedKVCache

ARCHS = ("granite-8b-reduced", "gemma2-2b-reduced")
ATOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    name = request.param
    rm, tm = r_build(r_arch(name)), t_build(t_arch(name))
    rp = rm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    return name, rm, rp, tm, tp


def _tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def test_params_carry_over(pair):
    name, rm, rp, tm, tp = pair
    ref = jax.tree_util.tree_leaves_with_path(rp)
    got = tree_util.leaves(tp)
    assert len(ref) == len(got)
    for (path, r), t in zip(ref, got):
        assert tuple(r.shape) == tuple(t.shape), path
    back = tree_util.leaves(lm_params_to_numpy(tp))
    for (_, r), b in zip(ref, back):
        np.testing.assert_array_equal(np.asarray(r), b)


def test_forward_and_loss_match_reference(pair):
    name, rm, rp, tm, tp = pair
    toks, labels = _tokens(2, 24), _tokens(2, 24, seed=1)
    r_logits, _ = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    t_logits, aux = tm.forward(tp, {"tokens": torch.tensor(toks)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=ATOL)
    r_loss = rm.loss(rp, {"tokens": jnp.asarray(toks),
                          "labels": jnp.asarray(labels)})
    t_loss = tm.loss(tp, {"tokens": torch.tensor(toks),
                          "labels": torch.tensor(labels)})
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-5)


def test_ring_cache_decode_matches_reference(pair):
    """Batched prefill of 12 tokens, then 8 decode steps: past gemma2's
    16-slot ring buffer, so its windowed layers wrap."""
    name, rm, rp, tm, tp = pair
    B, S0, NEW = 2, 12, 8
    toks = _tokens(B, S0, seed=2)
    rc, tc = rm.init_cache(B, S0 + NEW), tm.init_cache(B, S0 + NEW)
    r_log, rc = rm.decode_step(rp, rc, jnp.asarray(toks), jnp.arange(S0))
    t_log, tc = tm.decode_step(tp, tc, torch.tensor(toks), torch.arange(S0))
    np.testing.assert_allclose(t_log.numpy(), np.asarray(r_log), atol=ATOL)
    tok = np.asarray(jnp.argmax(r_log[:, -1], axis=-1))[:, None]
    for t in range(S0, S0 + NEW):
        assert (t_log[:, -1].argmax(-1).numpy() == tok[:, 0]).all()
        r_log, rc = rm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(t))
        t_log, tc = tm.decode_step(tp, tc, torch.tensor(tok), t)
        np.testing.assert_allclose(t_log.numpy(), np.asarray(r_log),
                                   atol=ATOL)
        tok = np.asarray(jnp.argmax(r_log[:, -1], axis=-1))[:, None]


def test_paged_path_matches_reference_and_dense(pair):
    """Paged prefill + decode against the reference's paged path and the
    port's own dense path, step by step.  gemma2 (windowed layers) is not
    paged in either package."""
    name, rm, rp, tm, tp = pair
    if not tm.supports_paged:
        assert not rm.supports_paged
        with pytest.raises(NotImplementedError):
            tm.init_paged_cache(8, 4)
        return
    from repro.serve import PagedKVCache as RCache
    B, S0, NEW = 3, 5, 4
    toks = _tokens(B, S0, seed=3)
    r_cache = RCache(rm, max_slots=B, max_seq_len=S0 + NEW, block_tokens=4)
    t_cache = PagedKVCache(tm, max_slots=B, max_seq_len=S0 + NEW,
                           block_tokens=4)
    for s in range(B):
        r_cache.ensure(s, S0 + NEW)
        t_cache.ensure(s, S0 + NEW)
    np.testing.assert_array_equal(t_cache.tables, r_cache.tables)
    r_tab, t_tab = r_cache.device_tables(), t_cache.device_tables()
    r_log, r_pool = rm.prefill_paged(rp, r_cache.pool, jnp.asarray(toks),
                                     r_tab)
    t_log, t_pool = tm.prefill_paged(tp, t_cache.pool, torch.tensor(toks),
                                     t_tab)
    dense = tm.init_cache(B, S0 + NEW)
    d_log, dense = tm.decode_step(tp, dense, torch.tensor(toks),
                                  torch.arange(S0))
    np.testing.assert_allclose(t_log.numpy(), np.asarray(r_log), atol=ATOL)
    torch.testing.assert_close(t_log, d_log, rtol=0, atol=1e-5)
    tok = t_log[:, -1].argmax(-1)[:, None]
    for t in range(S0, S0 + NEW - 1):
        r_log, r_pool = rm.decode_step_paged(
            rp, r_pool, jnp.asarray(tok.numpy()), jnp.full((B,), t), r_tab)
        t_log, t_pool = tm.decode_step_paged(
            tp, t_pool, tok, torch.full((B,), t), t_tab)
        d_log, dense = tm.decode_step(tp, dense, tok, t)
        np.testing.assert_allclose(t_log.numpy(), np.asarray(r_log),
                                   atol=ATOL)
        torch.testing.assert_close(t_log, d_log, rtol=0, atol=1e-5)
        tok = t_log[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_forward_matches_reference(name):
    rc = dataclasses.replace(r_arch(name), param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    tc = dataclasses.replace(t_arch(name), param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    rm, tm = r_build(rc), t_build(tc)
    rp = rm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), rp),
        dtype=torch.bfloat16)
    toks = _tokens(2, 24)
    r_logits, _ = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    t_logits, _ = tm.forward(tp, {"tokens": torch.tensor(toks)})
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=0.1)


def test_init_draws_in_the_parameter_dtype():
    cfg = dataclasses.replace(t_arch("granite-8b-reduced"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = t_build(cfg).init(torch.Generator().manual_seed(0))
    stacked = params["stack"]["blocks"]["l0"]["ffn"]["wi"]["w"]
    assert stacked.shape == (cfg.num_layers, cfg.d_model, cfg.d_ff)
    assert all(x.dtype == torch.bfloat16 for x in tree_util.leaves(params))
    # scale 1/sqrt(d_in), as the reference's init_linear
    assert abs(stacked.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("name", list_archs())
def test_every_arch_builds_with_the_reference_tree(name):
    """The full config builds; at the reduced widths in bf16 the port's
    ``init`` draws the reference's tree: the same keys, shapes and dtypes
    (the f32 leaves of a bf16 model, the MoE router and the Mamba2
    ``dt_bias``/``A_log``/``D``, included)."""
    assert t_build(t_arch(name)).cfg.name == name
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    rcfg = dataclasses.replace(r_arch(name + "-reduced"), **bf16)
    tcfg = dataclasses.replace(t_arch(name + "-reduced"), **bf16)
    want = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(r_build(rcfg).init, jax.random.PRNGKey(0)))
    params = t_build(tcfg).init(torch.Generator().manual_seed(0))
    got = tree_util.leaves(params)
    assert len(got) == len(want)
    paths = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            paths.append(path)
    walk(params, ())
    for (path, w), g, p in zip(want, got, paths):
        assert tuple(k.key for k in path) == p
        assert tuple(g.shape) == tuple(w.shape), p
        assert str(g.dtype).split(".")[-1] == str(w.dtype), p
