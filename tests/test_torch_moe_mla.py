"""The port's MoE FFN (``models/moe.py``) and MLA attention
(``models/common.py``) against the reference, CPU, f32.

The reference's parameters go through ``lm_params_from_numpy`` and both
packages get the same numpy inputs.  ``moe_block``'s output agrees within
atol 1e-5 and its aux within 1e-7 (the aux is ~1e-3), also where the
capacity is small enough that tokens drop: the same tokens must drop, or
their outputs would differ by O(1).  ``mla_block`` agrees within atol 1e-5
with and without its latent cache; deepseek-v2-lite-reduced's logits within
atol 1e-4, its loss within 1e-5 and its gradients within atol 1e-4 + rtol
1e-3, as ``test_torch_lm.py`` and ``test_torch_lm_train.py`` hold the dense
models.  Decode equals the forward pass within the reference's own bound
(atol 2e-3, rtol 1e-3, ``tests/test_models.py``) at capacity factor 8.0,
where no token drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_arch
from repro.models import build_model as r_build
from repro.models import common as RC
from repro.models import moe as RM
from repro_torch import tree as tree_util
from repro_torch.configs import get_arch as t_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core.robust import RobustConfig
from repro_torch.data.pipeline import TokenStream, make_worker_batches
from repro_torch.models import common as TC
from repro_torch.models import moe as TM
from repro_torch.models.registry import build_model as t_build
from repro_torch.optim.optimizers import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step

MOE_ARCHS = ("deepseek-v2-lite-16b-reduced", "kimi-k2-1t-a32b-reduced")
KEY = jax.random.PRNGKey(0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_port(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree))


def _moe_pair(name, **changes):
    cfg_r = dataclasses.replace(r_arch(name), **changes)
    cfg_t = dataclasses.replace(t_arch(name), **changes)
    rp = jax.jit(lambda k: RM.init_moe(k, cfg_r))(KEY)
    return cfg_r, cfg_t, rp, _to_port(rp)


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_block_matches_reference(name, capacity_factor):
    cfg_r, cfg_t, rp, tp = _moe_pair(name, capacity_factor=capacity_factor)
    x = _x((2, 16, cfg_r.d_model))
    r_out, r_aux = jax.jit(lambda p, x: RM.moe_block(p, cfg_r, x))(rp, x)
    t_out, t_aux = TM.moe_block(tp, cfg_t, torch.tensor(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), atol=1e-5)
    np.testing.assert_allclose(float(t_aux), float(r_aux), atol=1e-7)
    if capacity_factor < 1:
        # tokens did drop: the output differs from a no-drop run's
        full, _ = TM.moe_block(tp, dataclasses.replace(
            cfg_t, capacity_factor=8.0), torch.tensor(x))
        moved = (full - t_out).abs().amax(-1) > 1e-3
        assert 0 < int(moved.sum()) < moved.numel()


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``lax.top_k`` keeps the lower indices."""
    name = MOE_ARCHS[0]
    cfg_r, cfg_t, rp, tp = _moe_pair(name)
    rp = dict(rp, router={"w": jnp.zeros_like(rp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = _x((1, 8, cfg_r.d_model), seed=3)
    r_out, r_aux = jax.jit(lambda p, x: RM.moe_block(p, cfg_r, x))(rp, x)
    t_out, t_aux = TM.moe_block(tp, cfg_t, torch.tensor(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), atol=1e-5)
    np.testing.assert_allclose(float(t_aux), float(r_aux), atol=1e-7)


def test_moe_router_load_balance_aux():
    cfg = t_arch("deepseek-v2-lite-16b-reduced")
    p = TM.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out, aux = TM.moe_block(p, cfg, x)
    assert out.shape == x.shape
    # the aux's least value is coef * 1.0, at perfect balance
    assert float(aux) >= cfg.router_aux_loss_coef * 0.99
    assert p["router"]["w"].dtype == torch.float32


def test_moe_under_vmap_grad_matches_reference():
    """The dispatch (stable sorts, scatter_add counts, index_put) under the
    train step's transforms: per-group gradients within atol 1e-4."""
    name = MOE_ARCHS[0]
    cfg_r, cfg_t, rp, tp = _moe_pair(name)
    x = _x((3, 2, 8, cfg_r.d_model), seed=5)

    def r_loss(p, x):
        out, aux = RM.moe_block(p, cfg_r, x)
        return jnp.sum(out * out) + aux

    def t_loss(p, x):
        out, aux = TM.moe_block(p, cfg_t, x)
        return torch.sum(out * out) + aux

    r_g = jax.jit(jax.vmap(jax.grad(r_loss), in_axes=(None, 0)))(rp, x)
    t_g = torch.func.vmap(torch.func.grad(t_loss), in_dims=(None, 0))(
        tp, torch.tensor(x))
    for g, w in zip(tree_util.leaves(lm_params_to_numpy(t_g)),
                    jax.tree.leaves(r_g)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-3)


def test_mla_block_matches_reference_with_and_without_cache():
    name = "deepseek-v2-lite-16b-reduced"
    cfg_r, cfg_t = r_arch(name), t_arch(name)
    rp = jax.jit(lambda k: RC.init_mla(k, cfg_r))(KEY)
    tp = _to_port(rp)
    B, S = 2, 8
    x = _x((B, S, cfg_r.d_model), seed=2)
    pos = np.arange(S)
    r_mla = jax.jit(lambda p, x, pos, c: RC.mla_block(p, cfg_r, x,
                                                      positions=pos, cache=c))
    r_out, _ = r_mla(rp, x, jnp.asarray(pos), None)
    t_out, none = TC.mla_block(tp, cfg_t, torch.tensor(x),
                               positions=torch.tensor(pos))
    assert none is None
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), atol=1e-5)

    # a prefill of 4 positions, then decode steps into the latent cache
    r_cache = RC.init_mla_cache(cfg_r, B, S)
    t_cache = TC.init_mla_cache(cfg_t, B, S)
    steps = [np.arange(4)] + [np.array([t]) for t in range(4, S)]
    for p in steps:
        r_o, r_cache = r_mla(rp, x[:, p], jnp.asarray(p), r_cache)
        t_o, back = TC.mla_block(tp, cfg_t, torch.tensor(x[:, p]),
                                 positions=torch.tensor(p), cache=t_cache)
        assert back is t_cache                  # written in place
        np.testing.assert_allclose(t_o.numpy(), np.asarray(r_o), atol=1e-5)
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(t_cache[k].numpy(),
                                       np.asarray(r_cache[k]), atol=1e-5)
    # the cached pass equals the training pass
    np.testing.assert_allclose(t_o.numpy()[:, 0], t_out.numpy()[:, -1],
                               atol=1e-5)


@pytest.fixture(scope="module")
def deepseek():
    """The reference and port models and one set of initial parameters
    (the port's draw, as numpy) for each."""
    name = "deepseek-v2-lite-16b-reduced"
    rm, tm = r_build(r_arch(name)), t_build(t_arch(name))
    init = lm_params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    return rm, jax.tree.map(jnp.asarray, init), tm, _to_port(init)


def test_deepseek_forward_loss_and_grads_match_reference(deepseek):
    rm, rp, tm, tp = deepseek
    rng = np.random.default_rng(0)
    V = r_arch("deepseek-v2-lite-16b-reduced").vocab_size
    batch = {"tokens": rng.integers(0, V, (2, 16)),
             "labels": rng.integers(0, V, (2, 16))}
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    r_logits, r_aux = jax.jit(rm.forward)(rp, jb)
    t_logits, t_aux = tm.forward(tp, tb)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=1e-4)
    np.testing.assert_allclose(float(t_aux), float(r_aux), atol=1e-7)
    r_loss, r_g = jax.jit(jax.value_and_grad(rm.loss))(rp, jb)
    t_g, t_loss = torch.func.grad_and_value(tm.loss)(tp, tb)
    np.testing.assert_allclose(float(t_loss), float(r_loss), atol=1e-5)
    for g, w in zip(tree_util.leaves(lm_params_to_numpy(t_g)),
                    jax.tree.leaves(r_g)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-3)


def test_deepseek_decode_matches_forward():
    cfg = dataclasses.replace(t_arch("deepseek-v2-lite-16b-reduced"),
                              capacity_factor=8.0)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full, _ = model.forward(params, {"tokens": toks, "labels": toks})
    cache = model.init_cache(B, S)
    assert set(cache["blocks"]["l0"]["mixer"]) == {"ckv", "krope"}
    outs = []
    for t in range(S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_smoke_one_train_step(name):
    cfg = t_arch(name)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = OptConfig(name="sgd", lr=0.05)
    step = make_train_step(model, robust_cfg=RobustConfig(rule="trmean", b=1),
                           opt_cfg=opt_cfg, num_workers=4)
    batch = make_worker_batches(TokenStream(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8).batch(0), 4)
    p2, _, metrics = step(params, init_opt_state(opt_cfg, params), batch,
                          torch.Generator())
    assert torch.isfinite(metrics["loss"])
    assert metrics["loss_per_worker"].shape == (4,)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_util.leaves(params), tree_util.leaves(p2)))
    assert all(torch.isfinite(x).all() for x in tree_util.leaves(p2))
