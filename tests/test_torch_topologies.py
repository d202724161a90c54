"""The port's topology layer against ``repro.experiment``: the recorder's
counters and gauges on a defended ``sync_ps`` run, the topology metadata and
its refusals, every checked-in scenario on the CPU, and sweeps.

The defended run goes through both packages from the same parameters and
batches under a deterministic attack (signflip): counter values equal,
gauges at rtol 1e-4 (``steps_per_sec`` is a wall-clock rate and is only
checked to exist).
"""
import dataclasses
import functools
import glob
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.core import registry as rreg
from repro.compress.spec import CompressionSpec as RCompression
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.defense.reputation import DefenseConfig
from repro.faults.spec import FaultSpec
from repro.obs.metrics import ObsConfig as RObs
from repro_torch.convert import params_from_numpy
from repro_torch.core import registry as treg
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import SpecError
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment import topologies as ttopo
from repro_torch.experiment import topology as ttopology
from repro_torch.obs import ObsConfig
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.streaming import STREAMING_IMPL_RULES

# the packages export the ``sweep`` function under the module's name
rsweep = importlib.import_module("repro.experiment.sweep")
tsweep = importlib.import_module("repro_torch.experiment.sweep")
SCENARIOS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "scenarios", "*.json")))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are tiny: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(**kw):
    base = dict(
        name="topo-t", model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule="phocas", b=2, q=2),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        num_workers=8, steps=3, log_every=1)
    base.update(kw)
    return rexp.ScenarioSpec(**base)


def _port(spec):
    return TSpec.from_json(spec.to_json())


# ---------------------------------------------------------------------------
# the recorder on sync_ps: counters and gauges as the reference's
# ---------------------------------------------------------------------------

def _capture(module, monkeypatch):
    """Record the Recorder that ``module``'s loops build."""
    holder = {}
    orig = module.make_recorder

    def make(*a, **kw):
        holder["rec"] = orig(*a, **kw)
        return holder["rec"]

    monkeypatch.setattr(module, "make_recorder", make)
    return holder


def _snapshot(registry):
    out = {}
    for name, kind, children in registry.families():
        for labels, metric in children:
            value = metric.count if kind == "histogram" else metric.value
            out[(name, kind, labels)] = value
    return out


def test_sync_ps_recorder_matches_reference(monkeypatch):
    spec = _small(model=rexp.ModelSpec(kind="mlp", dims=(32, 32, 10)),
                  data=rexp.DataSpec(dim=32, batch_per_worker=16, seed=1),
                  defense=DefenseConfig(reputation_decay=0.6,
                                        warmup_steps=1), steps=8)
    plan = rexp.resolve(spec, obs=RObs(profile_cost=False))
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    ref_rec = _capture(rexp.topologies, monkeypatch)
    rexp.topologies.SyncPS().run(plan)

    tplan = tresolve(_port(spec), device="cpu", obs=ObsConfig())
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    port_rec = _capture(ttopo, monkeypatch)
    params = params_from_numpy(init)
    res = ttopo.SyncPS().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))

    want = _snapshot(ref_rec["rec"].registry)
    got = _snapshot(port_rec["rec"].registry)
    assert set(got) == set(want)
    rate = ("steps_per_sec", "gauge", (("topology", "sync_ps"),))
    assert got.pop(rate) > 0 and want.pop(rate) > 0
    for key, value in want.items():
        if key[1] == "gauge":
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       err_msg=str(key))
        else:
            assert got[key] == value, key
    # the run ejected both Byzantine workers, and the registry saw it
    assert got[("ejections", "counter", (("stream", "train"),))] == 2
    assert got[("steps", "counter", (("topology", "sync_ps"),))] == 8
    assert got[("span_ms", "histogram", (("name", "train_step"),
                                         ("rule", "phocas")))] == 8
    assert res.history[-1]["n_active"] == 6


def test_recorder_counts_adaptations(monkeypatch):
    """adapt_b raises b to q̂ and counts it; the JSONL ``train`` records
    keep their fields."""
    rec = _capture(ttopo, monkeypatch)
    spec = _port(_small(robust=RobustConfig(rule="phocas", b=1),
                        attack=AttackConfig(name="signflip",
                                            num_byzantine=3),
                        defense=DefenseConfig(adapt_b=True,
                                              adapt_patience=1),
                        steps=4))
    res = trun(spec, device="cpu", obs=ObsConfig())
    reg = rec["rec"].registry
    assert reg.get("adaptations").value >= 1
    assert res.robust_cfg.b == 3
    assert any("adapted_b" in r for r in res.history)


# ---------------------------------------------------------------------------
# topology metadata and refusals
# ---------------------------------------------------------------------------

FLAGS = ("supports_mesh", "supports_defense", "supports_adapt_b",
         "param_names", "attack_allowlist", "requires_streaming_rule",
         "fault_allowlist", "supports_resume", "supports_compression",
         "supports_stateful_codecs")


@pytest.mark.parametrize("name", ["sync_ps", "async_ps", "streaming",
                                  "serve"])
def test_topology_metadata_matches_reference(name):
    want = rexp.topology.get_topology(name)
    got = ttopology.get_topology(name)
    flags = {f: getattr(got, f) for f in FLAGS}
    flags["supports_mesh"] = getattr(want, "supports_mesh")  # item 10
    assert flags == {f: getattr(want, f) for f in FLAGS}
    assert ttopology.available_topologies() == \
        rexp.topology.available_topologies()


def test_streaming_rules_match_reference():
    assert treg.streaming_rules() == rreg.streaming_rules() == (
        "mean", "phocas", "trmean")
    assert set(STREAMING_IMPL_RULES) == set(treg.streaming_rules())
    for name in treg.available_rules():
        assert (treg.get_rule(name).supports_streaming
                == rreg.get_rule(name).supports_streaming), name


@pytest.mark.parametrize("overrides,match", [
    (dict(topology="streaming", robust=RobustConfig(rule="krum", q=2)),
     "streaming-capable rule"),
    (dict(topology="streaming",
          attack=AttackConfig(name="omniscient", num_byzantine=2)),
     "cannot be simulated"),
    (dict(topology="streaming", defense=DefenseConfig()),
     "does not support the defense loop"),
    (dict(topology="async_ps", defense=DefenseConfig(adapt_b=True)),
     "adapt_b"),
    (dict(topology="streaming",
          compression=RCompression(codec="topk")),
     "error-feedback state"),
    (dict(topology="async_ps", topology_params={"tau": 2}),
     "unknown topology_params"),
    (dict(faults=(FaultSpec(kind="crash", workers=(9,)),)), "out of range"),
    (dict(faults=(FaultSpec(kind="crash", workers=(4,)),),
          defense=DefenseConfig(adapt_b=True)), "adapt_b"),
    (dict(compression=RCompression(codec="topk", ratio=0.0)),
     "0 < ratio"),
    (dict(compression=RCompression(codec="zip")), "unknown codec"),
])
def test_spec_refusals_match_reference(overrides, match):
    spec = _small(**overrides)
    with pytest.raises(rexp.SpecError, match=match):
        spec.validate()
    with pytest.raises(SpecError, match=match):
        _port(spec).validate()


def test_resume_refusals(tmp_path):
    spec = _port(_small(topology="async_ps"))
    with pytest.raises(SpecError, match="does not support resume"):
        trun(spec, device="cpu", resume=str(tmp_path / "ck"))
    with pytest.raises(SpecError, match="needs spec.checkpoint_path"):
        trun(_port(_small()), device="cpu", resume=str(tmp_path / "ck"))


# ---------------------------------------------------------------------------
# every checked-in scenario, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SCENARIOS, ids=os.path.basename)
def test_example_scenario_validates_and_runs(path):
    spec = TSpec.load(path)
    with open(path) as f:
        assert spec.to_json() == f.read().strip()      # parses unchanged
    spec.validate()
    res = trun(spec, device="cpu")
    if spec.topology == "serve":
        assert res.final_metrics["completed"] > 0
        return
    assert len(res.history) == spec.steps
    for row in res.history:
        assert 0.0 <= row["eval"] <= 1.0
        if "loss" in row:
            assert np.isfinite(row["loss"])
    assert all(np.isfinite(x.numpy()).all()
               for x in jax.tree.leaves(res.params))


def test_scenarios_cover_every_topology_and_axis():
    specs = [TSpec.load(p) for p in SCENARIOS]
    assert len(specs) == 9
    assert {s.topology for s in specs} == {"sync_ps", "async_ps",
                                          "streaming", "serve"}
    assert any(s.faults for s in specs)
    assert any(s.compression.enabled for s in specs)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

def test_scenario_key_equals_reference():
    for path in SCENARIOS:
        assert tsweep.scenario_key(TSpec.load(path)) == \
            rsweep.scenario_key(rexp.ScenarioSpec.load(path))
    spec = _small()
    assert tsweep.scenario_key(_port(spec)) == rsweep.scenario_key(spec)
    other = dataclasses.replace(spec, seed=1)
    assert tsweep.scenario_key(_port(other)) != tsweep.scenario_key(
        _port(spec))


def test_sweep_cells_and_names_match_reference():
    axes = {"robust.rule": ["phocas", "trmean"],
            "attack.num_byzantine": [0, 2],
            "topology_params.staleness": [1]}
    base = _small(topology="async_ps")
    want = rsweep.sweep(base, axes)
    got = tsweep.sweep(_port(base), axes)
    assert [s.to_json() for s in got] == [s.to_json() for s in want]
    assert got[0].name == "topo-t[rule=phocas,num_byzantine=0,staleness=1]"
    with pytest.raises(KeyError, match="no field"):
        tsweep.sweep(_port(base), {"robust.nope": [1]})
    with pytest.raises(SpecError):
        tsweep.sweep(_port(base), {"robust.b": [9]})


def test_run_cached_hits_and_misses(tmp_path):
    calls = []
    runner = functools.partial(trun, device="cpu")

    def counted(spec):
        calls.append(spec.name)
        return runner(spec)

    spec = _port(_small(steps=2))
    first = tsweep.run_cached(spec, str(tmp_path), runner=counted)
    again = tsweep.run_cached(spec, str(tmp_path), runner=counted)
    assert calls == ["topo-t"]                       # the second one hit
    assert again.params is None and again.history == json.loads(
        json.dumps(first.history))
    other = dataclasses.replace(spec, seed=3)
    tsweep.run_cached(other, str(tmp_path), runner=counted)
    assert len(calls) == 2                           # a new key misses
    entry = os.path.join(str(tmp_path),
                         tsweep.scenario_key(spec) + ".json")
    with open(entry) as f:
        stored = json.load(f)
    stored["spec"]["seed"] = 7                       # hand-edited entry
    with open(entry, "w") as f:
        json.dump(stored, f)
    with pytest.raises(ValueError, match="different scenario"):
        tsweep.run_cached(spec, str(tmp_path), runner=counted)
    results = tsweep.run_sweep(spec, {"robust.b": [1, 2]},
                               cache_dir=str(tmp_path / "grid"),
                               runner=counted)
    assert [r.spec.robust.b for r in results] == [1, 2]
