"""The vector-wise rules (krum, multikrum, geomedian), their score and gated
hooks, and the mediam and mom plugins against the JAX reference.

Inputs come from a numpy seed and go through both packages.  Tolerances:

* the median helper and the scores built on it: atol 1e-6, and NaN at the
  same places (the same f32 operations on the same values);
* Krum score sums: atol (m-q-2) x (1e-6 * max d2 + 1e-3), the reference's
  Gram bound summed over the kept distances; selections exactly;
* Weiszfeld (geomedian): rtol 1e-4 and atol 1e-4, eight f32 iterations of
  sums taken in another order;
* mediam: atol 1e-5, the same sorted rows, median and window as the
  reference; mom: atol 1e-5, the group means are sums in another order;
* ``sync_ps`` runs: rtol 1e-4 on losses and gradient norms, as
  ``tests/test_torch_train.py``; ``active`` and q̂ exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.core import aggregators as ragg
from repro.core import registry as rreg
from repro.core import selection as rsel
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.defense import reputation as rrep
from repro.defense.reputation import DefenseConfig as RDefenseConfig
from repro_torch.convert import (defense_state_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core import aggregators as tagg
from repro_torch.core import registry as treg
from repro_torch.core import selection as tsel
from repro_torch.defense import read_jsonl
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import SpecError
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment.topologies import SyncPS
from repro_torch.optim.optimizers import init_opt_state


def _rng(seed):
    return np.random.default_rng(seed)


def _mat(m, d, seed, outliers=0):
    u = (1.0 + 0.5 * _rng(seed).standard_normal((m, d))).astype(np.float32)
    u[:outliers] *= -8.0
    return u


def _active(m, ejected=()):
    a = np.ones(m, np.float32)
    a[list(ejected)] = 0.0
    return a


def _close(got, want, **tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# the median repair
# ---------------------------------------------------------------------------

MEDIAN_CASES = {
    "nan": [1.0, np.nan, 2.0, 3.0, 4.0],
    "nan_even": [1.0, 2.0, np.nan, 4.0],
    "posinf_even": [1.0, 2.0, 3.0, np.inf],
    "posinf_middle": [np.inf, 1.0, np.inf, 2.0],
    "inf_pair": [-np.inf, np.inf],
    "overflow_midpoint": [3e38, 3e38],
    "even": [4.0, 1.0, 3.0, 2.0],
    "odd": [5.0, 1.0, 4.0],
}


@pytest.mark.parametrize("case", sorted(MEDIAN_CASES))
def test_median_has_jnp_median_semantics(case):
    """NaN anywhere gives NaN; an even count gives (lo + hi) * 0.5.  The
    port's distance-ratio scores follow: a NaN statistic makes every score
    NaN, as in the reference."""
    x = np.asarray(MEDIAN_CASES[case], np.float32)
    _close(tsel.vector_median(torch.tensor(x)).numpy(),
           jnp.median(jnp.asarray(x)), rtol=0, atol=0)
    raw = np.abs(x)
    _close(treg.distance_ratio_scores(torch.tensor(raw)).numpy(),
           rreg.distance_ratio_scores(jnp.asarray(raw)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "huge_row", "nan_row", "inf_row",
                                  "zero_median"])
def test_clip_rows_to_norm_quantile_matches_reference(case):
    u = _mat(9, 40, 4)
    if case == "huge_row":
        u[2] *= 1e6
    elif case == "nan_row":
        u[3, 7] = np.nan           # NaN norm: no row clipped at all
        u[5] *= 1e6
    elif case == "inf_row":
        u[1, 4] = np.inf
    elif case == "zero_median":
        u[:6] = 0.0
    got = tagg.clip_rows_to_norm_quantile(torch.tensor(u)).numpy()
    want = np.asarray(ragg.clip_rows_to_norm_quantile(jnp.asarray(u), ()))
    _close(got, want, rtol=1e-6, atol=1e-6)
    if case == "nan_row":
        np.testing.assert_array_equal(got[5], u[5])


# ---------------------------------------------------------------------------
# Krum's gated scores and the geometric median
# ---------------------------------------------------------------------------

def _score_tol(u, q):
    d2 = np.asarray(ragg._pairwise_sq_dists(jnp.asarray(u)))
    fin = np.isfinite(d2)
    return (u.shape[0] - q - 2) * (1e-6 * np.abs(d2[fin]).max() + 1e-3)


@pytest.mark.parametrize("ejected", [(), (0,), (0, 1, 5)])
def test_krum_gated_scores_match_reference(ejected):
    m, q = 12, 3
    u = _mat(m, 64, 6, outliers=3)
    act = _active(m, ejected)
    raw, gated = tagg.krum_gated_scores(torch.tensor(u), torch.tensor(act), q)
    rraw, rgated = ragg.krum_gated_scores_sharded(
        jnp.asarray(u), jnp.asarray(act), q, ())
    tol = _score_tol(u, q)
    _close(raw.numpy(), rraw, rtol=0, atol=tol)
    _close(gated.numpy(), rgated, rtol=0, atol=tol)
    # the distances may come from the caller (the Gram kernel's)
    d2 = tagg._pairwise_sq_dists(torch.tensor(u))
    raw2, gated2 = tagg.krum_gated_scores(torch.tensor(u), torch.tensor(act),
                                          q, d2=d2)
    assert torch.equal(raw2, raw) and torch.equal(gated2, gated)


def test_gated_krum_under_1e20_rows_matches_reference():
    """Rows at 1e20 have an infinite distance e_i to the median row, and
    0 * inf makes their gated distances NaN even with every worker active.
    The reference's ``argmin`` then returns the first NaN score: the gated
    pick is worker 0, a Byzantine row.  The port reproduces the
    reference's choice (ROADMAP queue 3)."""
    m, q = 8, 2
    u = _mat(m, 50, 0)
    u[:q] = -1e20 * u[:q]
    act = _active(m)
    rule = treg.make_rule("krum", treg.RuleParams(q=q, backend="xla"))
    agg, scores = rule.reduce_gated_with_scores(torch.tensor(u),
                                                torch.tensor(act))
    ragg_, rscores = rreg.make_rule("krum", rreg.RuleParams(
        q=q, backend="xla")).reduce_gated_with_scores(jnp.asarray(u),
                                                      jnp.asarray(act))
    np.testing.assert_array_equal(agg.numpy(), np.asarray(ragg_))
    np.testing.assert_array_equal(agg.numpy(), u[0])
    _close(scores.numpy(), rscores, rtol=0, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 4, 8])
def test_geomedian_with_dists_matches_reference(iters):
    u = _mat(10, 96, iters, outliers=2)
    u[1] *= 1e4                                # clipped before Weiszfeld
    z, dists = tagg.geomedian_weiszfeld(torch.tensor(u), iters,
                                        with_dists=True)
    rz, rdists = ragg.geomedian_sharded(jnp.asarray(u), (), iters=iters,
                                        with_dists=True)
    _close(z.numpy(), rz, rtol=1e-4, atol=1e-4)
    _close(dists.numpy(), rdists, rtol=1e-4, atol=1e-4)
    tree = torch.tensor(u).reshape(10, 8, 12)
    rule = treg.make_rule("geomedian", treg.RuleParams(geomedian_iters=iters))
    got = rule.reduce(tree)
    assert got.shape == (8, 12)
    _close(got.numpy().ravel(), ragg.geomedian(jnp.asarray(u), iters=iters),
           rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the rules' hooks, every backend
# ---------------------------------------------------------------------------

def _rule_params(mod, backend):
    return mod.RuleParams(b=2, q=3, multikrum_k=None, geomedian_iters=6,
                          backend=backend)


@pytest.mark.parametrize("ejected", [None, (), (0, 2)])
@pytest.mark.parametrize("rule,backend", [
    ("krum", "auto"), ("krum", "pallas"), ("krum", "xla"),
    ("multikrum", "auto"), ("multikrum", "pallas"), ("multikrum", "xla"),
    ("geomedian", "xla"), ("mediam", "xla"), ("mediam", "auto")])
def test_score_hooks_match_reference(rule, backend, ejected):
    m = 12
    u = _mat(m, 3 * 30, 9, outliers=3)
    act = None if ejected is None else _active(m, ejected)
    want_agg, want_scores = rreg.make_rule(
        rule, _rule_params(rreg, "xla")).reduce_gated_with_scores(
            jnp.asarray(u), None if act is None else jnp.asarray(act))
    trule = treg.make_rule(rule, _rule_params(treg, backend))
    got_agg, got_scores = trule.reduce_gated_with_scores(
        torch.tensor(u).reshape(m, 3, 30),
        None if act is None else torch.tensor(act))
    assert got_agg.shape == (3, 30) and got_scores.shape == (m,)
    tol = 1e-4 if rule == "geomedian" else 1e-5
    _close(got_agg.numpy().ravel(), want_agg, rtol=tol, atol=tol)
    _close(got_scores.numpy(), want_scores, rtol=0, atol=1e-4)
    assert np.all(got_scores.numpy()[:3] > 0.5)        # the outliers
    if ejected is None:
        agg, scores = trule.reduce_with_scores(torch.tensor(u))
        assert torch.equal(scores, got_scores)
        np.testing.assert_array_equal(agg.numpy(),
                                      got_agg.numpy().ravel())


@pytest.mark.parametrize("m,b", [(5, 1), (8, 3), (20, 6)])
def test_mediam_trim_family_matches_reference(m, b):
    u = _mat(m, 70, m, outliers=b)
    act = _active(m, (1,))
    for active in (None, act):
        for with_scores in (False, True):
            got = tsel.trim_family(
                torch.tensor(u), b, "mediam", with_scores=with_scores,
                active=None if active is None else torch.tensor(active))
            want = rsel.trim_family(
                jnp.asarray(u), b, "mediam", with_scores=with_scores,
                active=None if active is None else jnp.asarray(active))
            _close(got[0].numpy(), want[0], rtol=0, atol=1e-5)
            if with_scores:
                np.testing.assert_array_equal(got[1].numpy(),
                                              np.asarray(want[1]))
    agg = treg.make_rule("mediam", treg.RuleParams(b=b)).reduce(
        torch.tensor(u))
    _close(agg.numpy(), rreg.make_rule("mediam", rreg.RuleParams(
        b=b, backend="xla")).reduce(jnp.asarray(u)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,b", [(1, 0), (5, 0), (5, 2), (9, 3), (20, 6),
                                 (20, 9)])
def test_mom_matches_reference(m, b):
    u = _mat(m, 3 * 11, m + b, outliers=b).reshape(m, 3, 11)
    got = treg.make_rule("mom", treg.RuleParams(b=b)).reduce(torch.tensor(u))
    want = rreg.make_rule("mom", rreg.RuleParams(b=b, backend="xla")).reduce(
        jnp.asarray(u))
    assert got.shape == (3, 11)
    _close(got.numpy(), want, rtol=0, atol=1e-5)


def test_mom_refuses_b_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        treg.make_rule("mom", treg.RuleParams(b=3)).reduce(torch.zeros(5, 4))


# ---------------------------------------------------------------------------
# registry metadata and spec validation
# ---------------------------------------------------------------------------

META = ("coordinate_wise", "resilience", "uses_b", "uses_q", "has_kernel",
        "emits_scores", "fused_gate")


def test_registry_metadata_and_enumerators_match_reference():
    ported = set(treg.available_rules())
    assert ported == set(rreg.available_rules()) - {"signvote"}
    for name in ported:
        t, r = treg.get_rule(name), rreg.get_rule(name)
        assert {k: getattr(t, k) for k in META} == {
            k: getattr(r, k) for k in META}, name
    for fn in ("coordinate_wise_rules", "vector_wise_rules", "robust_rules",
               "kernel_rules", "score_rules", "fused_gate_rules"):
        want = tuple(n for n in getattr(rreg, fn)() if n != "signvote")
        assert getattr(treg, fn)() == want, fn
    assert treg.vector_wise_rules() == ("geomedian", "krum", "multikrum")
    with pytest.raises(NotImplementedError, match="item 13"):
        treg.get_rule("signvote")


def test_robust_config_passes_the_vector_rule_parameters():
    from repro_torch.core.robust import RobustConfig as TRobust
    rc = TRobust(rule="multikrum", b=1, q=4, multikrum_k=3,
                 geomedian_iters=5, backend="xla")
    p = rc.rule_params()
    assert (p.b, p.q, p.multikrum_k, p.geomedian_iters, p.backend) == (
        1, 4, 3, 5, "xla")
    assert rc.rule_obj()._k(12) == 3


def _ref_spec(rule, steps=4, attack="signflip", defense=None, q=2, m=8,
              telemetry=""):
    return rexp.ScenarioSpec(
        name=f"vector-parity-{rule}",
        model=rexp.ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=rexp.DataSpec(dim=32, batch_per_worker=8, seed=1),
        robust=RobustConfig(rule=rule, b=2, q=q),
        attack=AttackConfig(name=attack, num_byzantine=2),
        defense=defense, num_workers=m, steps=steps, log_every=1,
        telemetry_path=telemetry)


@pytest.mark.parametrize("q,ok", [(5, True), (6, False), (-1, False)])
@pytest.mark.parametrize("rule", ["krum", "multikrum"])
def test_spec_validates_q_as_the_reference(rule, q, ok):
    spec = dataclasses.replace(_ref_spec(rule), robust=RobustConfig(
        rule=rule, b=2, q=q))
    tspec = TSpec.from_json(spec.to_json())
    if ok:
        spec.validate()
        tspec.validate()
        return
    with pytest.raises(rexp.SpecError, match="q <= m-3"):
        spec.validate()
    with pytest.raises(SpecError, match="q <= m-3"):
        tspec.validate()


@pytest.mark.parametrize("rule,ok", [("krum", True), ("multikrum", True),
                                     ("mediam", True), ("geomedian", False)])
def test_adapt_b_needs_b_or_q_as_the_reference(rule, ok):
    spec = _ref_spec(rule, defense=RDefenseConfig(adapt_b=True))
    tspec = TSpec.from_json(spec.to_json())
    if ok:
        spec.validate()
        tspec.validate()
        return
    with pytest.raises(rexp.SpecError, match="b/q"):
        spec.validate()
    with pytest.raises(SpecError, match="b/q"):
        tspec.validate()


# ---------------------------------------------------------------------------
# the slice as a whole: sync_ps with the vector-wise rules
# ---------------------------------------------------------------------------

def _run_both(spec, tmp_path):
    """Run ``spec`` in both packages from the reference's initial params,
    batches and (defended) reputation state; returns (ref, port) results
    and their telemetry records."""
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    rinit = (jax.tree.map(jnp.asarray, init),
             rexp.topologies.init_opt_state(plan.opt_cfg, init), None)
    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    params = params_from_numpy(init)
    tinit = (params, init_opt_state(tplan.opt_cfg, params))
    if spec.defense is not None:
        dstate = jax.tree.map(np.asarray,
                              rrep.init_reputation(spec.num_workers))
        rinit = rinit[:2] + (jax.tree.map(jnp.asarray, dstate),)
        tinit += (defense_state_from_numpy(dstate),)
        plan.telemetry_path = str(tmp_path / "ref.jsonl")
        tplan.telemetry_path = str(tmp_path / "port.jsonl")
    ref = rexp.topologies.SyncPS().run(plan, init_state=rinit)
    got = SyncPS().run(tplan, init_state=tinit)
    return ref, got


def _assert_runs_agree(ref, got, spec):
    assert len(got.history) == len(ref.history)
    for key in ("loss", "grad_norm"):
        _close([r[key] for r in got.history if key in r],
               [r[key] for r in ref.history if key in r], rtol=1e-4,
               atol=1e-6)
    for r, t in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    jax.tree.leaves(params_to_numpy(got.params))):
        _close(t, r, rtol=1e-4, atol=1e-5)
    if spec.defense is not None:
        # q̂, n_active and the adapt events; eval reads each package's own
        # eval data, and wall is the host clock
        def rest(h):
            return [{k: v for k, v in r.items()
                     if k not in ("loss", "grad_norm", "eval", "wall")}
                    for r in h]
        assert rest(got.history) == rest(ref.history)


@pytest.mark.parametrize("attack", ["signflip", "zero", "omniscient"])
@pytest.mark.parametrize("rule", ["krum", "multikrum", "geomedian"])
def test_sync_ps_matches_reference_step_by_step(rule, attack, tmp_path):
    spec = _ref_spec(rule, attack=attack)
    ref, got = _run_both(spec, tmp_path)
    _assert_runs_agree(ref, got, spec)
    assert all(np.isfinite(r["loss"]) for r in got.history)


@pytest.mark.parametrize("rule,attack", [("krum", "signflip"),
                                         ("multikrum", "zero"),
                                         ("geomedian", "signflip"),
                                         ("geomedian", "omniscient")])
def test_defended_sync_ps_matches_reference_step_by_step(rule, attack,
                                                         tmp_path):
    spec = _ref_spec(rule, steps=8, attack=attack,
                     defense=RDefenseConfig(reputation_decay=0.6,
                                            warmup_steps=1))
    ref, got = _run_both(spec, tmp_path)
    _assert_runs_agree(ref, got, spec)
    rrecs = read_jsonl(str(tmp_path / "ref.jsonl"))
    trecs = read_jsonl(str(tmp_path / "port.jsonl"))
    assert len(trecs) == len(rrecs) == spec.steps
    for t, r in zip(trecs, rrecs):
        np.testing.assert_allclose(t["suspicion"], r["suspicion"], atol=1e-4)
        np.testing.assert_allclose(t["reputation"], r["reputation"],
                                   atol=1e-4)
        assert t["active"] == r["active"] and t["q_hat"] == r["q_hat"]


def test_krum_adapt_b_moves_q_as_the_reference(tmp_path):
    """Krum uses q and no b: adapt_b raises q to the detector's q̂ once it
    exceeds q for adapt_patience steps, in both packages alike."""
    spec = _ref_spec("krum", steps=10, q=0, m=10,
                     defense=RDefenseConfig(adapt_b=True, adapt_patience=1,
                                            eject_below=0.0,
                                            detector_min_gap=0.05))
    ref, got = _run_both(spec, tmp_path)
    _assert_runs_agree(ref, got, spec)
    events = [r for r in got.history if "adapted_q" in r]
    assert events, got.history
    assert got.robust_cfg.q == ref.robust_cfg.q == events[-1]["adapted_q"]
    assert got.robust_cfg.q >= 2 and got.robust_cfg.b == 2
    # a fresh port run on its own data adapts q the same way
    tres = trun(TSpec.from_json(spec.to_json()), device="cpu")
    assert tres.robust_cfg.q >= 2
