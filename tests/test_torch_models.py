"""repro_torch MLP/CNN and the ravel order against the JAX reference.

The reference's parameters are exported as numpy and converted with
``repro_torch.convert``; logits, loss and per-worker gradients are held at
atol 1e-5.  ``flatten_stacked`` must lay out the (m, D) worker matrix exactly
as ``jax.flatten_util.ravel_pytree`` does, since the attacks index its
columns.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import robust as rrobust
from repro.core.attacks import AttackConfig as RAttackConfig
from repro.models import cnn as rcnn
from repro.models import mlp as rmlp
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import robust as trobust
from repro_torch.core.attacks import AttackConfig as TAttackConfig
from repro_torch.models import cnn as tcnn
from repro_torch.models import mlp as tmlp

# atol 1e-5, plus rtol 1e-5 (~80 ulp) for the CNN's O(10-50) logits, whose
# convolutions accumulate in another order in XLA and in PyTorch.
ATOL, RTOL = 1e-5, 1e-5
M = 4


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _case(kind):
    """(reference params, reference loss fn, port loss fn, logits fns,
    worker-stacked numpy batch)."""
    rng = np.random.default_rng(0)
    if kind == "mlp":
        init = functools.partial(rmlp.init_mlp_classifier,
                                 dims=(16, 32, 24, 10))
        x = rng.standard_normal((M, 6, 16)).astype(np.float32)
        fns = (rmlp.mlp_loss, tmlp.mlp_loss, rmlp.mlp_logits,
               tmlp.mlp_logits)
    else:
        init = functools.partial(rcnn.init_cnn, in_ch=3, size=8)
        x = rng.standard_normal((M, 3, 8, 8, 3)).astype(np.float32)
        fns = (rcnn.cnn_loss, tcnn.cnn_loss, rcnn.cnn_logits,
               tcnn.cnn_logits)
    # The reference's parameter shapes, filled from the numpy seed (biases
    # non-zero so their gradients and layout are exercised).
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) or 100.0)
                   ).astype(np.float32),
        jax.eval_shape(init, jax.random.PRNGKey(0)))
    y = rng.integers(0, 10, x.shape[:2]).astype(np.int32)
    return params, fns, {"x": x, "y": y}


def _torch_batch(batch):
    return {"x": torch.tensor(batch["x"]),
            "y": torch.tensor(batch["y"]).long()}


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_logits_and_loss_match(kind):
    params, (rloss, tloss, rlogits, tlogits), batch = _case(kind)
    tparams = params_from_numpy(params)
    x0 = batch["x"][0]
    np.testing.assert_allclose(
        tlogits(tparams, torch.tensor(x0)).numpy(),
        jax.jit(rlogits)(params, x0), atol=ATOL, rtol=RTOL)
    one = {"x": batch["x"][0], "y": batch["y"][0]}
    np.testing.assert_allclose(
        float(tloss(tparams, {k: v[0] for k, v in
                              _torch_batch(batch).items()})),
        float(jax.jit(rloss)(params, one)), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_per_worker_gradients_match(kind):
    params, (rloss, tloss, _, _), batch = _case(kind)
    rlosses, rgrads = jax.jit(jax.vmap(jax.value_and_grad(rloss),
                                       in_axes=(None, 0)))(params, batch)
    tgrads, tlosses = torch.func.vmap(torch.func.grad_and_value(tloss),
                                      in_dims=(None, 0))(
        params_from_numpy(params), _torch_batch(batch))
    np.testing.assert_allclose(tlosses.numpy(), rlosses, atol=ATOL,
                               rtol=RTOL)
    rflat = jax.tree.leaves(_numpy_tree(rgrads))
    tflat = jax.tree.leaves(params_to_numpy(tgrads))
    assert len(rflat) == len(tflat)
    for r, t in zip(rflat, tflat):
        assert r.shape == t.shape
        np.testing.assert_allclose(t, r, atol=ATOL, rtol=RTOL)


def _ravel_rows(stacked):
    m = jax.tree.leaves(stacked)[0].shape[0]
    return np.stack([np.asarray(ravel_pytree(
        jax.tree.map(lambda x: x[i], stacked))[0]) for i in range(m)])


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_flatten_order_is_ravel_pytree_order(kind):
    params, _, _ = _case(kind)
    # every coordinate distinct: a permuted column shows up exactly
    count = [0]

    def stacked_leaf(p):
        n = M * p.size
        leaf = np.arange(count[0], count[0] + n, dtype=np.float32)
        count[0] += n
        return leaf.reshape((M,) + p.shape)

    stacked = jax.tree.map(stacked_leaf, params)
    want = _ravel_rows(stacked)
    got = trobust.flatten_stacked(params_from_numpy(stacked)).numpy()
    assert np.array_equal(got, want)
    back = trobust.unflatten_like(torch.tensor(want[1]),
                                  params_from_numpy(stacked))
    for r, t in zip(jax.tree.leaves(stacked),
                    jax.tree.leaves(params_to_numpy(back))):
        assert np.array_equal(t, r[1])


@pytest.mark.parametrize("rule,attack,q", [("phocas", "signflip", 1),
                                           ("trmean", "zero", 1),
                                           ("median", "omniscient", 1)])
def test_aggregate_stacked_tree_matches(rule, attack, q):
    params, _, _ = _case("mlp")
    rng = np.random.default_rng(5)
    stacked = jax.tree.map(
        lambda p: rng.standard_normal((M,) + p.shape).astype(np.float32),
        params)
    rcfg = rrobust.RobustConfig(rule=rule, b=1, backend="xla",
                                attack=RAttackConfig(name=attack,
                                                     num_byzantine=q))
    tcfg = trobust.RobustConfig(rule=rule, b=1, backend="xla",
                                attack=TAttackConfig(name=attack,
                                                     num_byzantine=q))
    want = rrobust.aggregate_stacked_tree(
        jax.tree.map(jnp.asarray, stacked), rcfg, jax.random.PRNGKey(0))
    got = trobust.aggregate_stacked_tree(params_from_numpy(stacked), tcfg,
                                         torch.Generator())
    for r, t in zip(jax.tree.leaves(_numpy_tree(want)),
                    jax.tree.leaves(params_to_numpy(got))):
        np.testing.assert_allclose(t, r, atol=1e-4, rtol=1e-6)


def test_convert_round_trip_is_identity():
    params, _, _ = _case("cnn")
    back = params_to_numpy(params_from_numpy(params))
    for r, t in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert r.shape == t.shape and np.array_equal(r, t)
