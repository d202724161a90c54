"""The port's ``streaming`` topology: exact against the port's batch rules
(atol 2e-5, as ``tests/test_streaming.py``), step for step against
``repro.train.streaming`` under the deterministic attacks (rtol 1e-4 on
losses and parameters, suspicion at atol 1e-5), and memory-bounded: no
tensor of a step holds the (m, |θ|) worker matrix.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro import experiment as rexp
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.defense.reputation import DefenseConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.attacks import AttackConfig as TAttack
from repro_torch.core.robust import RobustConfig as TRobust
from repro_torch.data.pipeline import ClassificationData, make_worker_batches
from repro_torch.defense import read_jsonl
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import SpecError
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment.topologies import Streaming
from repro_torch.models.mlp import build_mlp_model
from repro_torch.optim import OptConfig
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train import streaming as tstream
from repro_torch.train.step import make_train_step

M, DIM = 8, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are tiny: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(rule, attack=TAttack(), b=2):
    data = ClassificationData(num_classes=10, dim=DIM, noise=0.8, seed=1)
    model = build_mlp_model(dims=(DIM, 32, 10))
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = OptConfig(name="sgd", lr=0.1)
    rob = TRobust(rule=rule, b=b, q=b, attack=attack)
    batch = make_worker_batches(data.batch(0, 16 * M), M)
    return model, params, opt_cfg, rob, init_opt_state(opt_cfg, params), \
        batch


@pytest.mark.parametrize("rule,attack", [
    ("mean", "none"), ("trmean", "none"), ("phocas", "none"),
    ("trmean", "zero"), ("phocas", "signflip")])
def test_streaming_equals_batch(rule, attack):
    """One streaming step == one step of the vmapped batch rule.  (Phocas
    under ``zero`` is left out: two equal rows make distance ties that the
    batch rule's window search and the stable merge break differently, in
    the reference as here.)"""
    model, params, opt_cfg, rob, opt_state, batch = _setup(
        rule, TAttack(name=attack, num_byzantine=2))
    s_batch = make_train_step(model, robust_cfg=rob, opt_cfg=opt_cfg,
                              num_workers=M)
    s_stream = tstream.make_streaming_train_step(
        model, robust_cfg=rob, opt_cfg=opt_cfg, num_workers=M)
    p1, _, m1 = s_batch(params, opt_state, batch, torch.Generator())
    p2, _, m2 = s_stream(params, opt_state, batch, 0)
    for a, c in zip(jax.tree.leaves(params_to_numpy(p1)),
                    jax.tree.leaves(params_to_numpy(p2))):
        np.testing.assert_allclose(a, c, atol=2e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)


class _Sizes(TorchFunctionMode):
    """The largest tensor any torch call of a block returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_streaming_never_holds_the_worker_matrix():
    model, params, opt_cfg, rob, opt_state, batch = _setup("phocas")
    d = sum(x.numel() for x in jax.tree.leaves(params))
    s_stream = tstream.make_streaming_train_step(
        model, robust_cfg=rob, opt_cfg=opt_cfg, num_workers=M)
    with _Sizes() as sizes:
        s_stream(params, opt_state, batch, 0)
    assert sizes.largest <= (2 * rob.b + 1) * d < M * d
    # the same probe sees the batch step's (m, |θ|) matrix
    s_batch = make_train_step(model, robust_cfg=rob, opt_cfg=opt_cfg,
                              num_workers=M)
    with _Sizes() as sizes:
        s_batch(params, opt_state, batch, torch.Generator())
    assert sizes.largest >= M * d


def _ref_spec(rule, attack, telemetry="", steps=3):
    return rexp.ScenarioSpec(
        name="stream-parity", topology="streaming",
        model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule=rule, b=2, q=2),
        attack=AttackConfig(name=attack, num_byzantine=2),
        num_workers=M, steps=steps, log_every=1, telemetry_path=telemetry)


@pytest.mark.parametrize("rule,attack", [("phocas", "signflip"),
                                         ("trmean", "zero"),
                                         ("phocas", "zero")])
def test_streaming_matches_reference(rule, attack, tmp_path):
    rtel, ttel = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    spec = _ref_spec(rule, attack, rtel)
    ref = rexp.run_experiment(spec)
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.telemetry_path = ttel
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    params = params_from_numpy(init)
    got = Streaming().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))
    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    for t, r in zip(jax.tree.leaves(params_to_numpy(got.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)
    rrecs = [r for r in read_jsonl(rtel) if r["kind"] == "streaming"]
    trecs = [r for r in read_jsonl(ttel) if r["kind"] == "streaming"]
    assert len(trecs) == len(rrecs) == spec.steps
    for t, r in zip(trecs, rrecs):
        assert set(t) == set(r)
        if rule == "phocas":
            np.testing.assert_allclose(t["suspicion"], r["suspicion"],
                                       atol=1e-5)


def test_streaming_refuses_what_it_cannot_stream():
    model, params, opt_cfg, rob, opt_state, batch = _setup("mean")
    with pytest.raises(ValueError, match="streaming mode supports"):
        tstream.make_streaming_train_step(
            model, robust_cfg=TRobust(rule="krum"), opt_cfg=opt_cfg,
            num_workers=M)
    step = tstream.make_streaming_train_step(
        model, robust_cfg=dataclasses.replace(
            rob, attack=TAttack(name="omniscient", num_byzantine=2)),
        opt_cfg=opt_cfg, num_workers=M)
    with pytest.raises(ValueError, match="not supported in streaming"):
        step(params, opt_state, batch, 0)
    spec = TSpec.from_json(dataclasses.replace(
        _ref_spec("phocas", "signflip"),
        defense=DefenseConfig()).to_json())
    with pytest.raises(SpecError, match="defense loop"):
        trun(spec, device="cpu")


def test_shim_equals_run_experiment():
    spec = TSpec.from_json(_ref_spec("phocas", "gaussian").to_json())
    res = trun(spec, device="cpu")
    plan = tresolve(spec, device="cpu")
    hist = tstream.run_streaming_training(
        plan.model, plan.batch_fn, plan.robust_cfg, plan.opt_cfg,
        num_workers=M, steps=spec.steps, seed=spec.seed,
        eval_fn=plan.eval_fn, device="cpu")
    by_step = {r["step"]: r for r in res.history}
    assert [r["step"] for r in hist] == [0, 2]      # record_every 10
    for r in hist:
        assert r == by_step[r["step"]]


def test_worker_attacks_recompute_identically():
    """The second pass recomputes each corrupted gradient: the draws are a
    function of (seed, leaf, worker), independent across workers."""
    g = {"a": {"w": torch.randn(64, 8)}, "b": torch.randn(16)}
    cfg = TAttack(name="gaussian", num_byzantine=2)
    one = tstream._worker_attack(cfg, g, 0, 11)
    again = tstream._worker_attack(cfg, g, 0, 11)
    other = tstream._worker_attack(cfg, g, 1, 11)
    assert torch.equal(one["a"]["w"], again["a"]["w"])
    assert not torch.equal(one["a"]["w"], other["a"]["w"])
    assert tstream._worker_attack(cfg, g, 2, 11) is g     # honest worker
    assert tstream._path_salt("a/w") != tstream._path_salt("b")


def test_streaming_bitflip_hits_honest_workers_as_the_reference_does():
    """The reference's streaming bitflip draws one victim per coordinate in
    [0, 20) and flips the worker with index ≡ victim (mod 20), ignoring q
    and m: at m = 8 about 8/20 of the coordinates are hit, spread over every
    worker.  The port reproduces it (ROADMAP queue 3)."""
    g = {"w": torch.full((4000,), 0.5)}
    cfg = TAttack(name="bitflip", num_byzantine=1)
    hits = torch.stack([tstream._worker_attack(cfg, g, w, 5)["w"] != 0.5
                        for w in range(M)])
    assert hits.sum(0).max() <= 1                   # one victim a coordinate
    assert all(hits[w].any() for w in range(M))     # honest workers too
    np.testing.assert_allclose(float(hits.any(0).float().mean()), M / 20,
                               atol=0.03)
