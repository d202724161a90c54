"""The port's fault axis against ``repro.faults`` and the reference's
degraded rounds.

The injector is numpy in both packages, so the ``FaultRound`` sequence of
the chaos list is compared bit for bit.  Degraded rounds run in both
packages from the reference's parameters and batches under a deterministic
attack (signflip): losses, presence and parameters at rtol 1e-4, the
defense state's ``active`` exactly, on ``sync_ps``, ``async_ps``
(staleness 1) and ``streaming``.
"""

import jax
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.compress.spec import CompressionSpec as RCompression
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.defense.reputation import DefenseConfig
from repro.faults import injector as rinj
from repro.faults import spec as rfspec
from repro.faults.spec import FaultSpec
from repro_torch.compress import codecs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.attacks import AttackConfig as TAttack
from repro_torch.core.robust import RobustConfig as TRobust
from repro_torch.defense import read_jsonl
from repro_torch.defense.reputation import DefenseConfig as TDefense
from repro_torch.defense.reputation import init_reputation, update_presence
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment import topologies as ttopo
from repro_torch.faults import injector as tinj
from repro_torch.faults import spec as tfspec
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train import async_sgd

M = 8
CHAOS = (FaultSpec(kind="crash", workers=(4,), step=2),
         FaultSpec(kind="straggler", workers=(5,), delay_steps=2, jitter=1),
         FaultSpec(kind="flaky", workers=(6,), p_drop=0.3),
         FaultSpec(kind="pod", workers=(7,),
                   inner=FaultSpec(kind="silent")))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are tiny: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_faults(faults):
    return TSpec.from_json(rexp.ScenarioSpec(
        faults=faults, num_workers=M).to_json()).faults


def _small(**kw):
    base = dict(
        name="faults-t", model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule="phocas", b=2, q=2),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        num_workers=M, steps=6, log_every=1, faults=CHAOS)
    base.update(kw)
    return rexp.ScenarioSpec(**base)


@pytest.mark.parametrize("m,seed", [(8, 0), (8, 7), (20, 3)])
def test_fault_rounds_equal_reference_bit_for_bit(m, seed):
    ref = rinj.make_injector(CHAOS, m, seed)
    got = tinj.make_injector(_port_faults(CHAOS), m, seed)
    for step in range(50):
        r, t = ref.collect(step), got.collect(step)
        np.testing.assert_array_equal(t.present, r.present)
        assert (t.m_eff, t.retries, t.timeouts, t.crashed, t.degraded) == (
            r.m_eff, r.retries, r.timeouts, r.crashed, r.degraded)
        np.testing.assert_array_equal(t.index, r.index)
    assert tinj.make_injector((), m, seed) is None


@pytest.mark.parametrize("faults", [
    (FaultSpec(kind="nope", workers=(0,)),),
    (FaultSpec(kind="crash", workers=()),),
    (FaultSpec(kind="crash", workers=(0, 0)),),
    (FaultSpec(kind="crash", workers=(99,)),),
    (FaultSpec(kind="straggler", workers=(0,)),),
    (FaultSpec(kind="flaky", workers=(0,), p_drop=1.0),),
    (FaultSpec(kind="pod", workers=(0, 1),
               inner=FaultSpec(kind="pod")),),
    (FaultSpec(kind="crash", workers=(0,)),
     FaultSpec(kind="silent", workers=(0,))),
    (FaultSpec(kind="crash", workers=(0, 1, 2, 3, 4, 5, 6)),),
])
def test_fault_validation_matches_reference(faults):
    with pytest.raises(rfspec.FaultError) as want:
        rfspec.validate_faults(faults, M)
    with pytest.raises(tfspec.FaultError) as got:
        tfspec.validate_faults(_port_faults(faults), M)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rule,b,q,q_atk,absent", [
    ("phocas", 2, 2, 2, []),
    ("phocas", 3, 3, 3, [1, 2, 5, 6]),
    ("trmean", 3, 3, 2, [0, 3, 4, 5, 6]),
    ("krum", 2, 4, 2, [2, 3, 4]),
    ("multikrum", 1, 3, 3, [0, 1, 2, 3, 4, 5]),
])
def test_resolve_quorum_matches_reference(rule, b, q, q_atk, absent):
    present = np.ones(M, dtype=bool)
    present[absent] = False
    rc = RobustConfig(rule=rule, b=b, q=q, attack=AttackConfig(
        name="signflip", num_byzantine=q_atk))
    tc = TRobust(rule=rule, b=b, q=q, attack=TAttack(
        name="signflip", num_byzantine=q_atk))
    r_eff, r_atk = rinj.resolve_quorum(rc, present)
    t_eff, t_atk = tinj.resolve_quorum(tc, present)
    assert (t_eff.b, t_eff.q, t_eff.attack.num_byzantine, t_atk) == (
        r_eff.b, r_eff.q, r_eff.attack.num_byzantine, r_atk)
    assert (t_eff is tc) == (r_eff is rc)        # healthy round: identity


def _inputs(spec):
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    tplan.eval_fn = None
    return init, tplan


def _same_params(got, ref):
    for t, r in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("defended", [False, True])
def test_degraded_sync_ps_matches_reference(defended, tmp_path):
    rtel, ttel = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    spec = _small(telemetry_path=rtel, defense=DefenseConfig(
        reputation_decay=0.6, warmup_steps=1) if defended else None)
    ref = rexp.run_experiment(spec)
    init, tplan = _inputs(spec)
    tplan.telemetry_path = ttel
    params = params_from_numpy(init)
    got = ttopo.SyncPS().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))
    for key in ("step", "present"):
        assert [r[key] for r in got.history] == [r[key] for r in ref.history]
    assert min(r["present"] for r in got.history) < M
    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    _same_params(got.params, ref.params)
    faults = [{k: v for k, v in r.items() if k != "t"}
              for r in read_jsonl(ttel) if r["kind"] == "fault"]
    assert faults == [{k: v for k, v in r.items() if k != "t"}
                      for r in read_jsonl(rtel) if r["kind"] == "fault"]
    assert any("b_eff" in r for r in faults)
    if defended:
        for k in ("active", "presence", "reputation"):
            np.testing.assert_allclose(got.defense_state[k].numpy(),
                                       np.asarray(ref.defense_state[k]),
                                       atol=1e-5, err_msg=k)


def test_faulty_async_matches_reference():
    spec = _small(topology="async_ps", topology_params={"staleness": 1},
                  faults=(FaultSpec(kind="crash", workers=(4,), step=1),
                          FaultSpec(kind="straggler", workers=(5,),
                                    delay_steps=2)), steps=6)
    ref = rexp.run_experiment(spec)
    init, tplan = _inputs(spec)
    init_fn, _ = async_sgd.make_async_train_step(
        tplan.model, robust_cfg=tplan.robust_cfg, opt_cfg=tplan.opt_cfg,
        acfg=async_sgd.AsyncConfig(num_workers=M), faulty=True)
    state = init_fn(torch.Generator().manual_seed(0))
    state["params"] = params_from_numpy(init)
    state["worker_params"] = {
        k: {n: x.unsqueeze(0).repeat((M,) + (1,) * x.dim())
            for n, x in v.items()} for k, v in state["params"].items()}
    got = ttopo.AsyncPS().run(tplan, init_state=state)
    for key in ("present", "m_fresh"):
        assert [r[key] for r in got.history] == [r[key] for r in ref.history]
    # worker 4's slot goes stale past 2·tau and leaves the multiset
    assert got.history[-1]["m_fresh"] == M - 1
    _same_params(got.params, ref.params)


def test_degraded_streaming_matches_reference():
    spec = _small(topology="streaming")
    ref = rexp.run_experiment(spec)
    init, tplan = _inputs(spec)
    params = params_from_numpy(init)
    got = ttopo.Streaming().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))
    assert [r["present"] for r in got.history] == \
        [r["present"] for r in ref.history]
    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    _same_params(got.params, ref.params)


@pytest.mark.parametrize("topology,rule", [
    (t, r) for t in ("sync_ps", "async_ps", "streaming")
    for r in ("phocas", "trmean", "krum")
    if not (t == "streaming" and r == "krum")])
def test_chaos_grid_completes_and_degrades(topology, rule):
    spec = TSpec.from_json(_small(
        topology=topology, robust=RobustConfig(rule=rule, b=2, q=2),
        attack=AttackConfig(name="gaussian", num_byzantine=2)).to_json())
    res = trun(spec, device="cpu")
    assert len(res.history) == spec.steps
    assert min(r["present"] for r in res.history) < M
    assert all(torch.isfinite(x).all()
               for x in jax.tree.leaves(res.params))


@pytest.mark.parametrize("topology", ["sync_ps", "streaming"])
def test_lost_rounds_are_skipped_not_fatal(topology):
    """Three stragglers of period 4 leave one worker in every 4th round: no
    2-worker quorum, the round is dropped, the run finishes."""
    spec = TSpec.from_json(_small(
        topology=topology, num_workers=4,
        robust=RobustConfig(rule="phocas", b=1, q=1),
        attack=AttackConfig(name="gaussian", num_byzantine=1), steps=8,
        faults=(FaultSpec(kind="straggler", workers=(1, 2, 3),
                          delay_steps=3),)).to_json())
    res = trun(spec, device="cpu")
    seen = {r["step"] for r in res.history}
    lost = {s for s in range(8) if all((s + w) % 4 for w in (1, 2, 3))}
    assert lost and not (lost & seen)
    assert seen == set(range(8)) - lost


def test_absence_feeds_presence_not_suspicion():
    state = init_reputation(4)
    rep0 = state["reputation"].clone()
    for _ in range(5):
        state = update_presence(state, torch.tensor([1.0, 0.0, 1.0, 1.0]),
                                TDefense())
    pres = state["presence"]
    assert pres[1] < 0.6 < float(pres[[0, 2, 3]].min())
    assert torch.equal(state["reputation"], rep0)
    assert bool(state["active"].all())


def test_defended_fault_run_tracks_presence():
    spec = TSpec.from_json(_small(
        defense=DefenseConfig(), attack=AttackConfig(name="none"),
        faults=(FaultSpec(kind="crash", workers=(5,), step=1),)).to_json())
    res = trun(spec, device="cpu")
    pres = res.defense_state["presence"]
    assert pres[5] < 1.0 and float(pres[:5].min()) > float(pres[5])
    assert bool(res.defense_state["active"].all())


def test_faults_with_a_stateful_codec_keep_absent_residuals(monkeypatch):
    """Error-feedback rows travel with their workers: each round encodes
    the present rows only, with their own residuals."""
    seen = []
    encode = codecs.TopKCodec.encode

    def record(codec, u, state, gen):
        seen.append(u.shape[0])
        return encode(codec, u, state, gen)

    monkeypatch.setattr(codecs.TopKCodec, "encode", record)
    spec = TSpec.from_json(_small(
        faults=(FaultSpec(kind="silent", workers=(7,)),), steps=3,
        compression=RCompression(codec="topk", ratio=0.1)).to_json())
    res = trun(spec, device="cpu")
    assert seen == [M - 1] * 3                      # compacted every round
    assert np.isfinite(res.final_loss)
