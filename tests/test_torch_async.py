"""The port's ``async_ps`` topology against ``repro.train.async_sgd``.

Both packages start from the reference's parameters and run on its batches
(exported as numpy).  torch cannot reproduce ``jax.random``, so the
trajectories are compared under deterministic draws: at ``staleness = 1``
every worker refreshes every step, and at ``staleness = 2`` the test computes
the reference's refresh vectors from its own key split and feeds them to the
port through ``async_sgd.refresh_draw``.  The attacks are the deterministic
ones (signflip, zero, omniscient).  Final parameters and every
``staleness_frac`` agree at rtol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.defense.reputation import DefenseConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import make_worker_batches
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment.topologies import AsyncPS
from repro_torch.train import async_sgd

M = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are tiny: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(rule="phocas", attack="signflip", staleness=1, steps=4,
          defense=None):
    return rexp.ScenarioSpec(
        name="async-parity", topology="async_ps",
        topology_params={"staleness": staleness, "update_clip": 10.0},
        model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule=rule, b=2, q=2),
        attack=AttackConfig(name=attack, num_byzantine=2),
        defense=defense, num_workers=M, steps=steps, log_every=1)


def _port_run(spec, init):
    """The port's AsyncPS from the reference's initial parameters and on
    its batches."""
    plan = rexp.resolve(spec)
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    tplan.eval_fn = None
    init_fn, _ = async_sgd.make_async_train_step(
        tplan.model, robust_cfg=tplan.robust_cfg, opt_cfg=tplan.opt_cfg,
        acfg=async_sgd.AsyncConfig(num_workers=M),
        defense_cfg=tplan.defense_cfg)
    state = init_fn(torch.Generator().manual_seed(0))
    params = params_from_numpy(init)
    state["params"] = params
    state["worker_params"] = {
        k: {n: x.unsqueeze(0).repeat((M,) + (1,) * x.dim())
            for n, x in v.items()} for k, v in params.items()}
    return AsyncPS().run(tplan, init_state=state)


def _reference(spec):
    ref = rexp.run_experiment(spec)
    init = jax.tree.map(np.asarray, rexp.resolve(spec).model.init(
        jax.random.PRNGKey(spec.seed)))
    return ref, init


def _assert_same(got, ref):
    np.testing.assert_allclose(
        [r["staleness_frac"] for r in got.history],
        [r["staleness_frac"] for r in ref.history], rtol=1e-4)
    for t, r in zip(jax.tree.leaves(params_to_numpy(got.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rule,attack", [("phocas", "signflip"),
                                         ("trmean", "zero"),
                                         ("phocas", "omniscient")])
def test_async_staleness_1_matches_reference(rule, attack):
    spec = _spec(rule, attack)
    ref, init = _reference(spec)
    got = _port_run(spec, init)
    assert [r["staleness_frac"] for r in got.history] == [0.0] * spec.steps
    _assert_same(got, ref)


def test_async_staleness_2_with_the_references_refresh_draws(monkeypatch):
    """The reference draws ``bernoulli(k_refresh, 1/tau, (m,))`` with
    ``k_refresh, _ = split(fold_in(PRNGKey(seed), i))``; the port takes the
    same vectors through ``refresh_draw``."""
    spec = _spec(staleness=2, steps=5)
    ref, init = _reference(spec)
    key = jax.random.PRNGKey(spec.seed)
    draws = [np.asarray(jax.random.bernoulli(
        jax.random.split(jax.random.fold_in(key, i))[0], 0.5, (M,)))
        for i in range(spec.steps)]
    assert 0 < sum(d.sum() for d in draws) < M * spec.steps
    it = iter(draws)
    monkeypatch.setattr(async_sgd, "refresh_draw",
                        lambda gen, m, tau, device: torch.tensor(next(it)))
    got = _port_run(spec, init)
    _assert_same(got, ref)


def test_defended_async_matches_reference():
    spec = _spec(defense=DefenseConfig(reputation_decay=0.6,
                                       warmup_steps=1), steps=5)
    ref, init = _reference(spec)
    got = _port_run(spec, init)
    _assert_same(got, ref)
    assert ([r["q_hat"] for r in got.history]
            == [r["q_hat"] for r in ref.history])
    np.testing.assert_allclose(
        got.defense_state["reputation"].numpy(),
        np.asarray(ref.defense_state["reputation"]), atol=1e-5)
    np.testing.assert_array_equal(got.defense_state["active"].numpy(),
                                  np.asarray(ref.defense_state["active"]))


def test_shim_equals_run_experiment():
    spec = TSpec.from_json(_spec(staleness=2, steps=3).to_json())
    res = trun(spec, device="cpu")
    plan = tresolve(spec, device="cpu")
    hist = async_sgd.run_async_training(
        plan.model, plan.batch_fn, plan.robust_cfg, plan.opt_cfg,
        async_sgd.AsyncConfig(num_workers=M, staleness=2, seed=spec.seed),
        spec.steps, eval_fn=plan.eval_fn, device="cpu")
    assert [r["step"] for r in hist] == [0, 2]      # record_every 10
    by_step = {r["step"]: r for r in res.history}
    for r in hist:
        assert r == by_step[r["step"]]


def test_worker_copies_are_real_and_refresh_per_row():
    """Each worker's stale copy is its own storage, and a step rewrites
    exactly the rows that refresh."""
    tspec = TSpec.from_json(_spec(staleness=3).to_json())
    plan = tresolve(tspec, device="cpu")
    init_fn, step = async_sgd.make_async_train_step(
        plan.model, robust_cfg=plan.robust_cfg, opt_cfg=plan.opt_cfg,
        acfg=async_sgd.AsyncConfig(num_workers=M, staleness=3))
    state = init_fn(torch.Generator().manual_seed(0))
    w = state["worker_params"]["fc1"]["w"]
    assert w.stride(0) != 0
    batch = make_worker_batches(plan.batch_fn(0), M)
    new, metrics = step(state, batch, torch.Generator().manual_seed(4))
    moved = [not torch.equal(new["worker_params"]["fc1"]["w"][i], w[i])
             for i in range(M)]
    fresh = [torch.equal(new["worker_params"]["fc1"]["w"][i],
                         new["params"]["fc1"]["w"]) for i in range(M)]
    assert moved == fresh
    np.testing.assert_allclose(float(metrics["staleness_frac"]),
                               1.0 - sum(fresh) / M)
