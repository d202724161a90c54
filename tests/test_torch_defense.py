"""The repro_torch defense loop against ``repro.defense`` and the reference's
selection, rules and ``defense_step``.

Inputs come from a numpy seed and go through both packages: stable ranks,
drop counts and ``active``/q̂ must agree exactly; aggregates at atol 1e-4
(phocas with the boundary-tie allowance of ``tests/test_kernels.py``),
scores and reputation at atol 1e-5.  Eight defended ``sync_ps`` steps run in
both packages from the same parameters, defense state and batches, and their
telemetry records are compared step by step.  The behaviour tests (slowburn,
adapt_b) run the port on its own data and assert what the reference's
``tests/test_defense.py`` asserts.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import _assert_phocas_close

from repro import experiment as rexp
from repro.core import aggregators as raggregators
from repro.core import registry as rreg
from repro.core import selection as rsel
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.core.robust import aggregate_matrix as raggregate
from repro.defense import detector as rdet
from repro.defense import reputation as rrep
from repro.defense.reputation import DefenseConfig as RDefenseConfig
from repro_torch.convert import (defense_state_from_numpy,
                                 defense_state_to_numpy, params_from_numpy)
from repro_torch.core import aggregators as taggregators
from repro_torch.core import registry as treg
from repro_torch.core import robust as trob
from repro_torch.core import selection as tsel
from repro_torch.defense import (DefenseConfig, TelemetryWriter, estimate_q,
                                 init_reputation, read_jsonl,
                                 resilience_monitor, suspicion_of,
                                 update_reputation)
from repro_torch.defense.reputation import update_presence
from repro_torch.experiment import DataSpec, ModelSpec
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import SpecError
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment.topologies import SyncPS
from repro_torch.optim.optimizers import init_opt_state

ATOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _rows(mat):
    return [mat[i] for i in range(mat.shape[0])]


# ---------------------------------------------------------------------------
# selection: stable ranks, trim family with scores and gate, gate_matrix
# ---------------------------------------------------------------------------

def _rank_keys(m, seed):
    rng = _rng(seed)
    k = np.round(rng.standard_normal((m, 40)), 1).astype(np.float32)
    k[:, :5] = 0.5                                    # all-equal columns
    k[rng.integers(0, m, 12), rng.integers(0, 40, 12)] = np.nan
    k[rng.integers(0, m, 6), rng.integers(0, 40, 6)] = np.inf
    k[rng.integers(0, m, 6), rng.integers(0, 40, 6)] = -np.inf
    return k


@pytest.mark.parametrize("m", [3, 8, 20, 64])
def test_stable_ranks_match_reference_exactly(m):
    keys = _rank_keys(m, m)
    want = rsel.stable_ranks(_rows(jnp.asarray(keys)))
    got = tsel.stable_ranks(_rows(torch.tensor(keys)))
    assert len(got) == m and got[0].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stable_ranks_past_the_pairwise_limit():
    """Above 64 workers both packages take a stable double argsort."""
    keys = _rank_keys(70, 70)
    keys[np.isnan(keys)] = 1.0
    want = rsel.stable_ranks(_rows(jnp.asarray(keys)))
    got = tsel.stable_ranks(_rows(torch.tensor(keys)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _active(m, pattern):
    if pattern is None:
        return None
    a = np.ones((m,), np.float32)
    if pattern == "ejected":
        a[[0, m // 2]] = 0.0
    return a


@pytest.mark.parametrize("pattern", [None, "all", "ejected"])
@pytest.mark.parametrize("kind", ["trmean", "phocas"])
@pytest.mark.parametrize("m", [5, 8, 20])
def test_trim_family_scores_and_gate_match_reference(m, kind, pattern):
    u = (3.0 * _rng(m).standard_normal((m, 130))).astype(np.float32)
    u[:, :10] = np.round(u[:, :10])                   # ties
    act = _active(m, pattern)
    for b in range((m + 1) // 2):
        ragg, rcounts, rn = rsel.trim_family(
            jnp.asarray(u), b, kind, with_scores=True,
            active=None if act is None else jnp.asarray(act))
        agg, counts, n = tsel.trim_family(
            torch.tensor(u), b, kind, with_scores=True,
            active=None if act is None else torch.tensor(act))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
        assert float(n) == float(rn) == 130.0
        gated = u if act is None else np.asarray(
            rsel.gate_matrix(jnp.asarray(u), jnp.asarray(act)))
        if kind == "phocas" and b > 0:
            _assert_phocas_close(jnp.asarray(gated), b, agg.numpy(),
                                 np.asarray(ragg), atol=ATOL)
        else:
            np.testing.assert_allclose(agg.numpy(), np.asarray(ragg),
                                       atol=ATOL, err_msg=f"b={b}")
    # without scores the counts stay None, as in the reference
    assert tsel.trim_family(torch.tensor(u), 1, kind)[1] is None
    # the rules' stats functions are the scored pass without a gate
    stats = {"trmean": (taggregators.trmean_stats,
                        raggregators.trmean_stats),
             "phocas": (taggregators.phocas_stats,
                        raggregators.phocas_stats)}[kind]
    b = (m + 1) // 2 - 1
    got, want = stats[0](torch.tensor(u), b), stats[1](jnp.asarray(u), b)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)


def test_gate_matrix_matches_reference():
    u = _rng(3).standard_normal((8, 5)).astype(np.float32)
    ones = torch.ones(8)
    t = torch.tensor(u)
    assert tsel.gate_matrix(t, ones) is t             # concrete short-circuit
    act = np.ones((8,), np.float32)
    act[[2, 5]] = 0.0
    got = tsel.gate_matrix(t, torch.tensor(act))
    want = rsel.gate_matrix(jnp.asarray(u), jnp.asarray(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.median(u, axis=0),
                               atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), u[0])


# ---------------------------------------------------------------------------
# registry: score normalizers, metadata, the gated hooks under each backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("baseline", [0.0, 0.1, 0.4, 0.6])
def test_drop_frequency_scores_match_reference(baseline):
    counts = _rng(5).integers(0, 500, 20).astype(np.float32)
    got = treg.drop_frequency_scores(torch.tensor(counts),
                                     tsel.ncoords_of(torch.zeros(20, 500)),
                                     baseline)
    want = rreg.drop_frequency_scores(jnp.asarray(counts),
                                      jnp.float32(500.0), baseline)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("m", [7, 8])
def test_distance_ratio_scores_match_reference(m):
    raw = np.abs(_rng(m).standard_normal(m)).astype(np.float32) + 0.1
    raw[0] = 40.0
    for x in (raw, np.zeros(m, np.float32)):
        got = treg.distance_ratio_scores(torch.tensor(x))
        want = rreg.distance_ratio_scores(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_score_rule_metadata():
    want = ("geomedian", "krum", "mediam", "multikrum", "phocas",
            "signvote", "trmean")
    assert treg.score_rules() == want
    assert treg.fused_gate_rules() == want
    assert treg.score_rules() == rreg.score_rules()
    assert not treg.get_rule("mean").emits_scores
    u = torch.tensor(_rng(0).standard_normal((8, 16)).astype(np.float32))
    agg, scores = treg.make_rule("mean").reduce_with_scores(u)
    np.testing.assert_array_equal(scores.numpy(), np.zeros(8, np.float32))
    np.testing.assert_allclose(agg.numpy(), u.mean(0).numpy(), atol=1e-6)
    active = np.array([0.0] + [1.0] * 7, np.float32)
    gagg, gscores = treg.make_rule("median").reduce_gated_with_scores(
        u, torch.tensor(active))
    np.testing.assert_array_equal(gscores.numpy(), np.zeros(8, np.float32))
    want = rreg.make_rule("median").reduce_gated_with_scores(
        jnp.asarray(u.numpy()), jnp.asarray(active))[0]
    np.testing.assert_allclose(gagg.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("pattern", [None, "all", "ejected"])
@pytest.mark.parametrize("rule", ["phocas", "trmean"])
def test_reduce_gated_with_scores_each_backend(rule, pattern, backend):
    m, b = 12, 3
    u = (1.0 + 0.1 * _rng(7).standard_normal((m, 4, 25))).astype(np.float32)
    u[:3] *= -10.0                                    # three outliers
    act = _active(m, pattern)
    want_agg, want_scores = rreg.make_rule(
        rule, rreg.RuleParams(b=b, backend="xla")).reduce_gated_with_scores(
            jnp.asarray(u), None if act is None else jnp.asarray(act))
    got_agg, got_scores = treg.make_rule(
        rule, treg.RuleParams(b=b, backend=backend)).reduce_gated_with_scores(
            torch.tensor(u), None if act is None else torch.tensor(act))
    assert got_agg.shape == (4, 25) and got_scores.shape == (m,)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               atol=1e-6)
    assert np.all(got_scores.numpy()[:3] > 0.5)
    gated = u if act is None else np.asarray(
        rsel.gate_matrix(jnp.asarray(u), jnp.asarray(act)))
    if rule == "phocas":
        _assert_phocas_close(jnp.asarray(gated.reshape(m, -1)), b,
                             got_agg.numpy().ravel(),
                             np.asarray(want_agg).ravel(), atol=ATOL)
    else:
        np.testing.assert_allclose(got_agg.numpy(), np.asarray(want_agg),
                                   atol=ATOL)


@pytest.mark.parametrize("rule", ["phocas", "trmean", "mean"])
def test_aggregate_matrix_with_scores_matches_reference(rule):
    """The engine: attack, then raw scores and the gated aggregate."""
    m = 20
    u = (1.0 + 0.1 * _rng(11).standard_normal((m, 64))).astype(np.float32)
    act = _active(m, "ejected")
    atk = AttackConfig(name="signflip", num_byzantine=4)
    ragg, rscores = raggregate(
        jnp.asarray(u), RobustConfig(rule=rule, b=4, attack=atk),
        jax.random.PRNGKey(0), active=jnp.asarray(act), with_scores=True)
    tcfg = trob.RobustConfig(rule=rule, b=4, attack=trob.AttackConfig(
        name="signflip", num_byzantine=4))
    tagg, tscores = trob.aggregate_matrix(
        torch.tensor(u), tcfg, torch.Generator().manual_seed(0),
        active=torch.tensor(act), with_scores=True)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(rscores),
                               atol=1e-6)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(ragg), atol=ATOL)
    plain = trob.aggregate_matrix(torch.tensor(u), tcfg,
                                  torch.Generator().manual_seed(0),
                                  active=torch.tensor(act))
    np.testing.assert_allclose(plain.numpy(), tagg.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# reputation, detector, monitor, telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(reputation_decay=1.5), dict(reputation_decay=0.0),
    dict(eject_below=0.8, readmit_above=0.5), dict(adapt_patience=0)])
def test_defense_config_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as want:
        RDefenseConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        DefenseConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert ([f.name for f in dataclasses.fields(DefenseConfig)]
            == [f.name for f in dataclasses.fields(RDefenseConfig)])


def _state_close(t, r):
    assert set(t) == set(r)
    for k in r:
        want = np.asarray(r[k])
        got = t[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=k)


def test_reputation_hysteresis_matches_reference():
    """The reference's eject-then-readmit sequence, state by state, plus the
    warmup, presence and suspicion views."""
    m = 6
    cfg = dict(reputation_decay=0.5, eject_below=0.5, readmit_above=0.7,
               warmup_steps=1)
    tcfg, rcfg = DefenseConfig(**cfg), RDefenseConfig(**cfg)
    t, r = init_reputation(m), rrep.init_reputation(m)
    _state_close(t, r)
    bad = np.zeros((m,), np.float32)
    bad[0] = 1.0
    trace = []
    for scores in [bad] * 6 + [np.zeros((m,), np.float32)] * 6:
        t = update_reputation(t, torch.tensor(scores), tcfg)
        r = rrep.update_reputation(r, jnp.asarray(scores), rcfg)
        _state_close(t, r)
        trace.append(float(t["active"][0]))
    assert 0.0 in trace[:6] and trace[-1] == 1.0     # ejected, readmitted
    assert np.all(t["active"][1:].numpy() == 1.0)
    warm = update_reputation(init_reputation(m), torch.tensor(bad),
                             DefenseConfig(reputation_decay=0.01,
                                           warmup_steps=3))
    assert float(warm["active"][0]) == 1.0
    present = np.array([1, 0, 1, 1, 0, 1], np.float32)
    _state_close(update_presence(t, torch.tensor(present), tcfg),
                 rrep.update_presence(r, jnp.asarray(present), rcfg))
    np.testing.assert_allclose(suspicion_of(t).numpy(),
                               np.asarray(rrep.suspicion_of(r)), atol=1e-6)


def _score_vectors():
    rng = _rng(23)
    noise = (0.03 * np.abs(rng.standard_normal(20))).astype(np.float32)
    bimodal = np.concatenate([0.9 + 0.05 * rng.random(5),
                              0.05 * rng.random(15)]).astype(np.float32)
    rng.shuffle(bimodal)
    return {
        "attenuated": np.array([0.16] * 4 + [0.01] * 16, np.float32),
        "noise": noise,
        "benign_scatter": np.array([0.37, 0.22, 0.19, 0.16] + [0.1] * 16,
                                   np.float32),
        "majority": np.array([1.0] * 15 + [0.0] * 5, np.float32),
        "bimodal": bimodal,
        "equal_gaps": np.array([1.0, 0.7, 0.4, 0.1, 0.1, 0.1], np.float32),
        "clean": np.zeros(8, np.float32),
        "two": np.array([0.9, 0.0], np.float32),
    }


@pytest.mark.parametrize("min_gap", [0.05, 0.2])
@pytest.mark.parametrize("name", sorted(_score_vectors()))
def test_estimate_q_matches_reference(name, min_gap):
    s = _score_vectors()[name]
    got = estimate_q(torch.tensor(s), min_gap=min_gap)
    want = int(rdet.estimate_q(jnp.asarray(s), min_gap=min_gap))
    assert got.dtype == torch.int32 and int(got) == want
    assert int(got) <= len(s) // 2                    # the cap at m/2


def test_estimate_q_reference_cases():
    vecs = _score_vectors()
    assert int(estimate_q(torch.tensor(vecs["attenuated"]))) == 4
    assert int(estimate_q(torch.tensor(vecs["noise"]))) == 0
    assert int(estimate_q(torch.tensor(vecs["benign_scatter"]))) == 0
    assert int(estimate_q(torch.tensor(vecs["majority"]))) <= 10
    assert int(estimate_q(torch.tensor(vecs["bimodal"]))) == 5


@pytest.mark.parametrize("case", ["clean", "broken", "codec"])
def test_resilience_monitor_matches_reference(case):
    m, d = 20, 64
    u = (1.0 + 0.1 * _rng(2).standard_normal((m, d))).astype(np.float32)
    atk = "signflip" if case == "broken" else "none"
    rcfg = RobustConfig(rule="phocas", b=4, q=4,
                        attack=AttackConfig(name=atk, num_byzantine=4))
    agg, scores = raggregate(jnp.asarray(u), rcfg, jax.random.PRNGKey(1),
                             with_scores=True)
    agg, scores = np.array(agg), np.array(scores)     # writable copies
    if case == "broken":                  # the mean: broken under signflip
        u = u.copy()
        u[:4] *= -10.0
        agg = u.mean(axis=0)
    codec = "signbit" if case == "codec" else "none"
    want = rdet.resilience_monitor(jnp.asarray(u), jnp.asarray(agg),
                                   jnp.asarray(scores), rule_name="phocas",
                                   b=4, codec=codec)
    got = resilience_monitor(torch.tensor(u), agg, torch.tensor(scores),
                             rule_name="phocas", b=4, codec=codec)
    assert got["q_hat"] == want["q_hat"]
    assert got["within_bound"] == want["within_bound"]
    for k in ("v_hat", "sq_dev", "delta_bound"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    assert got["within_bound"] is (case != "broken")


def test_telemetry_writer_roundtrip(tmp_path):
    path = str(tmp_path / "tel.jsonl")
    with TelemetryWriter(path) as tel:
        tel.log("train", 0, loss=0.5, suspicion=torch.tensor([0.0, 1.0]),
                q_hat=torch.tensor(1, dtype=torch.int32), note="ok")
        tel.log("serve", 3, tok_s=123.4)
        tel.log("train", 4, loss=float("nan"), grad_norm=float("inf"),
                suspicion=torch.tensor([0.5, float("inf")]),
                reputation=np.array([0.25, -np.inf], np.float32))
    recs = read_jsonl(path)
    assert len(recs) == 3
    assert recs[0]["kind"] == "train" and recs[0]["suspicion"] == [0.0, 1.0]
    assert recs[0]["q_hat"] == 1 and recs[1]["step"] == 3
    assert recs[2]["loss"] is None and recs[2]["grad_norm"] == 1e308
    assert recs[2]["suspicion"] == [0.5, 1e308]
    assert recs[2]["reputation"] == [0.25, -1e308]
    with open(path) as fh:                          # strict JSON lines
        for line in fh:
            json.loads(line, parse_constant=lambda c: 1 / 0)
    off = TelemetryWriter(None)
    off.log("train", 0, loss=1.0)
    assert not off.enabled


def test_defense_state_conversion_keeps_dtypes():
    ref = rrep.init_reputation(5)
    ref = rrep.update_reputation(ref, jnp.linspace(0, 1, 5),
                                 RDefenseConfig())
    state = defense_state_from_numpy(jax.tree.map(np.asarray, ref))
    assert state["steps"].dtype == torch.int32
    assert state["reputation"].dtype == torch.float32
    back = defense_state_to_numpy(state)
    for k in ref:
        assert back[k].dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(back[k], np.asarray(ref[k]))


# ---------------------------------------------------------------------------
# the slice as a whole: defended sync_ps against the reference
# ---------------------------------------------------------------------------

def _defended_ref_spec(rule, telemetry, steps=8):
    return rexp.ScenarioSpec(
        name=f"defense-parity-{rule}",
        model=rexp.ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=rexp.DataSpec(dim=32, batch_per_worker=16, seed=1),
        robust=RobustConfig(rule=rule, b=2, q=2),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        defense=RDefenseConfig(reputation_decay=0.6, warmup_steps=1),
        num_workers=8, steps=steps, log_every=1, telemetry_path=telemetry)


@pytest.mark.parametrize("rule", ["phocas", "trmean"])
def test_defended_sync_ps_matches_reference_step_by_step(rule, tmp_path):
    rtel, ttel = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    spec = _defended_ref_spec(rule, rtel)
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    dstate = jax.tree.map(np.asarray, rrep.init_reputation(8))
    ref = rexp.topologies.SyncPS().run(plan, init_state=(
        jax.tree.map(jnp.asarray, init),
        rexp.topologies.init_opt_state(plan.opt_cfg, init),
        jax.tree.map(jnp.asarray, dstate)))

    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    assert tplan.telemetry_path == rtel
    tplan.telemetry_path = ttel
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    params = params_from_numpy(init)
    got = SyncPS().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params),
        defense_state_from_numpy(dstate)))

    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    np.testing.assert_allclose([r["grad_norm"] for r in got.history],
                               [r["grad_norm"] for r in ref.history],
                               rtol=1e-4)
    assert ([(r["q_hat"], r["n_active"]) for r in got.history]
            == [(r["q_hat"], r["n_active"]) for r in ref.history])
    rrecs, trecs = read_jsonl(rtel), read_jsonl(ttel)
    assert len(trecs) == len(rrecs) == spec.steps
    for t, r in zip(trecs, rrecs):
        assert set(t) == set(r) and t["kind"] == r["kind"] == "train"
        assert t["step"] == r["step"]
        np.testing.assert_allclose(t["suspicion"], r["suspicion"], atol=1e-5)
        np.testing.assert_allclose(t["reputation"], r["reputation"],
                                   atol=1e-5)
        assert t["active"] == r["active"] and t["q_hat"] == r["q_hat"]
    # the gate ran: both Byzantine workers end ejected, the rest active
    assert trecs[-1]["active"] == [0.0, 0.0] + [1.0] * 6
    _state_close(got.defense_state, ref.defense_state)


def test_scenario_json_with_defense_parses_unchanged_and_runs(tmp_path):
    tel = str(tmp_path / "tel.jsonl")
    spec = dataclasses.replace(
        _defended_ref_spec("trmean", "", steps=3),
        defense=RDefenseConfig(adapt_b=True, adapt_patience=3,
                               telemetry_path=tel))
    path = tmp_path / "sync_ps_defense.json"
    path.write_text(spec.to_json())
    tspec = TSpec.load(str(path))
    assert isinstance(tspec.defense, DefenseConfig)
    assert tspec.to_json() == path.read_text()
    res = trun(tspec, device="cpu")
    assert [r["step"] for r in res.history] == [0, 1, 2]
    assert all("q_hat" in r and "n_active" in r for r in res.history)
    recs = read_jsonl(tel)                  # defense.telemetry_path feeds it
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert set(recs[0]) == {"t", "kind", "step", "loss", "grad_norm",
                            "suspicion", "reputation", "active", "q_hat"}


def test_defense_spec_checks():
    base = TSpec.from_json(_defended_ref_spec("phocas", "").to_json())
    with pytest.raises(SpecError, match="score-emitting"):
        dataclasses.replace(
            base, robust=dataclasses.replace(base.robust, rule="median")
        ).validate()
    base.validate()


# ---------------------------------------------------------------------------
# behaviour, on the port's own data (the reference's test_defense.py claims)
# ---------------------------------------------------------------------------

def _robust(**kw):
    return trob.RobustConfig(**kw)


def test_slowburn_defeats_then_loses_to_reputation_via_scenario():
    m = 20
    spec = TSpec(
        name="slowburn", topology="sync_ps",
        model=ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=DataSpec(kind="classification", dim=32, batch_per_worker=8,
                      seed=1),
        robust=_robust(rule="phocas", b=6, q=6),
        attack=trob.AttackConfig(name="slowburn", num_byzantine=6,
                                 slowburn_trigger=10),
        defense=DefenseConfig(), num_workers=m, steps=25, log_every=1)
    res = trun(spec, device="cpu")
    pre = [r for r in res.history if r["step"] < 10]
    post = [r for r in res.history if r["step"] >= 20]
    assert all(r["q_hat"] == 0 for r in pre), pre
    assert all(r["n_active"] == m for r in pre), pre
    assert all(r["q_hat"] == 6 for r in post), post
    active = res.defense_state["active"].numpy()
    assert active[:6].sum() == 0, active
    assert active[6:].sum() == m - 6, active
    assert all(np.isfinite(r["loss"]) for r in res.history)


def test_adapt_b_recovers_underprovisioned_phocas():
    """phocas b=1 against q=6 signflip workers: adapt_b raises b to 6 and
    training recovers; ejection is off in both arms (eject_below=0)."""
    base = TSpec(
        name="adapt", topology="sync_ps",
        model=ModelSpec(kind="mlp", dims=(64, 64, 10)),
        data=DataSpec(kind="classification", dim=64, batch_per_worker=20,
                      seed=1),
        robust=_robust(rule="phocas", b=1, q=1),
        attack=trob.AttackConfig(name="signflip", num_byzantine=6),
        num_workers=20, steps=50, log_every=10)
    common = dict(eject_below=0.0, detector_min_gap=0.05)
    adaptive = trun(dataclasses.replace(
        base, defense=DefenseConfig(adapt_b=True, adapt_patience=1,
                                    **common)), device="cpu")
    fixed = trun(dataclasses.replace(
        base, defense=DefenseConfig(**common)), device="cpu")
    assert adaptive.robust_cfg.b == 6, adaptive.robust_cfg
    events = [r for r in adaptive.history if "adapted_b" in r]
    assert events and events[-1]["adapted_b"] == 6, events
    assert set(events[-1]) == {"step", "adapted_b", "adapted_q", "q_hat"}
    assert fixed.robust_cfg.b == 1
    assert adaptive.final_eval > 0.9, adaptive.final_eval
    assert fixed.final_eval < 0.5, fixed.final_eval
    assert adaptive.final_eval - fixed.final_eval > 0.4


def test_adapt_b_noop_on_clean_run():
    spec = TSpec(
        name="adapt-clean", topology="sync_ps",
        model=ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=DataSpec(kind="classification", dim=32, batch_per_worker=8),
        robust=_robust(rule="phocas", b=2, q=2),
        defense=DefenseConfig(adapt_b=True), num_workers=20, steps=8,
        log_every=4)
    res = trun(spec, device="cpu")
    assert res.robust_cfg.b == 2
    assert not any("adapted_b" in r for r in res.history)
