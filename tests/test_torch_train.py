"""The repro_torch slice as a whole against ``repro.experiment``.

Five ``sync_ps`` steps of the MLP at m=8 under ``signflip`` run in both
packages from the same initial parameters on the same batches (exported from
the reference as numpy); per-step losses and final parameters agree at
rtol 1e-4.  The checked-in scenario JSONs parse unchanged and run on the CPU,
axes the port does not run yet raise ``NotImplementedError``, and the defense
axis refuses a rule that emits no scores, as in the reference.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.defense.reputation import DefenseConfig
from repro.faults.spec import FaultSpec
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import SpecError
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment.topologies import SyncPS
from repro_torch.optim.optimizers import init_opt_state

SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "scenarios")


def _ref_spec(rule, steps=5):
    return rexp.ScenarioSpec(
        name=f"parity-{rule}",
        model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule=rule, b=2),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        num_workers=8, steps=steps, log_every=1)


@pytest.mark.parametrize("rule", ["phocas", "trmean"])
def test_sync_ps_matches_reference_step_by_step(rule):
    spec = _ref_spec(rule)
    ref = rexp.run_experiment(spec)
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]

    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    params = params_from_numpy(init)
    got = SyncPS().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))

    ref_losses = [r["loss"] for r in ref.history]
    got_losses = [r["loss"] for r in got.history]
    assert len(got_losses) == spec.steps
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose([r["grad_norm"] for r in got.history],
                               [r["grad_norm"] for r in ref.history],
                               rtol=1e-4)
    for r, t in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    jax.tree.leaves(params_to_numpy(got.params))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["sync_ps_gaussian", "sync_ps_bitflip"])
def test_scenario_json_runs_on_cpu(name):
    path = os.path.join(SCENARIOS, f"{name}.json")
    spec = TSpec.load(path)
    with open(path) as f:
        assert spec.to_json() == f.read().strip()    # parses unchanged
    assert spec.steps == 3
    res = trun(spec, device="cpu")
    assert [r["step"] for r in res.history] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["eval"] <= 1.0
               for r in res.history)
    assert res.final_loss < res.history[0]["loss"]


def _port_spec(**overrides):
    return TSpec.from_json(dataclasses.replace(
        _ref_spec("phocas", steps=1), **overrides).to_json())


@pytest.mark.parametrize("overrides,item", [
    (dict(faults=(FaultSpec(kind="crash", workers=(1,)),)), "item 13"),
    (dict(mesh="8x1"), "item 10"),
    (dict(checkpoint_path="ck.npz"), "item 9"),
    (dict(topology="async_ps"), "item 9"),
    (dict(robust=RobustConfig(rule="signvote")), "item 13"),
])
def test_unported_axes_raise(overrides, item):
    spec = _port_spec(**overrides)
    with pytest.raises(NotImplementedError, match=item):
        trun(spec, device="cpu")


def test_defense_needs_a_score_rule():
    """The defense axis is ported; as in the reference, it refuses a rule
    that emits no suspicion scores."""
    spec = _port_spec(defense=DefenseConfig(),
                      robust=RobustConfig(rule="mean", b=2))
    with pytest.raises(SpecError, match="score-emitting"):
        trun(spec, device="cpu")


def test_compression_and_arch_raise():
    from repro.compress.spec import CompressionSpec
    spec = _port_spec(compression=CompressionSpec(codec="int8"))
    with pytest.raises(NotImplementedError, match="item 13"):
        trun(spec, device="cpu")
    spec = _port_spec(model=rexp.ModelSpec(kind="arch",
                                           arch="gemma2-2b-reduced"),
                      data=rexp.DataSpec(kind="tokens"))
    with pytest.raises(NotImplementedError, match="item 11"):
        trun(spec, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        trun(_port_spec(), device="cpu", resume="ck.npz")
