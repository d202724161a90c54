"""The port's observability layer (``repro_torch.obs``) against the reference
on the CPU: the exposition text (golden file, each package's parser on the
other's output), the record schema, span nesting and the module-level span,
the histogram views, the reporter's summary and text, the step-cost count
(FLOPs against a hand count of the matmuls, the kernels' own reckoning, no
disturbance of the run), device memory and the profiler window."""
import contextlib
import io
import math
import os

import numpy as np
import pytest
import torch

from repro.obs import MetricsRegistry as RRegistry
from repro.obs import Recorder as RRecorder
from repro.obs import parse_exposition as r_parse
from repro.obs import render_prometheus as r_render
from repro.obs import validate_record as r_validate
from repro.obs.metrics import Histogram as RHistogram
from repro.obs.report import render as r_report_render
from repro.obs.report import summarize as r_summarize
from repro.obs.trace import current_path as r_current_path
from repro_torch.defense.telemetry import read_jsonl
from repro_torch.obs import (ENVELOPE, MetricsRegistry, ObsConfig, Recorder,
                             compiled_cost, device_memory_stats,
                             make_recorder, parse_exposition, profile_trace,
                             render_prometheus, set_default_recorder, span,
                             validate_record)
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.report import main as report_main
from repro_torch.obs.report import render as report_render
from repro_torch.obs.report import summarize
from repro_torch.obs.trace import NULL_SPAN, current_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "obs")


def _golden(reg):
    """tests/test_obs.py's golden registry, built in ``reg``."""
    reg.counter("ejections", stream="train").inc(2)
    reg.gauge("q_hat").set(1)
    reg.gauge("resilience_margin", rule="phocas").set(1.0)
    h = reg.histogram("agg_ms", buckets=(1.0, 10.0, 100.0), rule="phocas")
    for v in (0.5, 1.0, 7.5, 250.0):
        h.observe(v)
    return reg


def _mixed(reg):
    """A registry with awkward names, labels and values."""
    reg.counter("c", path='a"b\\c\nd').inc(3)
    reg.gauge("weird-name.x").set(float("nan"))
    reg.gauge("big").set(1e20)
    reg.gauge("neg", rule="trmean").set(float("-inf"))
    reg.gauge("frac").set(0.1)
    reg.histogram("span_ms", name="engine_step/decode").observe(2.5)
    return reg


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------

def test_exposition_golden_file():
    with open(os.path.join(FIXTURES, "golden.prom")) as fh:
        golden = fh.read()
    assert render_prometheus(_golden(MetricsRegistry())) == golden


@pytest.mark.parametrize("build", [_golden, _mixed])
def test_exposition_text_equals_reference(build):
    assert render_prometheus(build(MetricsRegistry())) == \
        r_render(build(RRegistry()))


def _same_families(a: dict, b: dict) -> bool:
    """parse_exposition results equal, NaN equal to NaN."""
    if a.keys() != b.keys():
        return False
    for name in a:
        if a[name]["type"] != b[name]["type"]:
            return False
        for (sa, la, va), (sb, lb, vb) in zip(a[name]["samples"],
                                              b[name]["samples"],
                                              strict=True):
            if (sa, la) != (sb, lb) or not (
                    va == vb or math.isnan(va) and math.isnan(vb)):
                return False
    return True


@pytest.mark.parametrize("build", [_golden, _mixed])
def test_each_parser_reads_the_others_output(build):
    port_text = render_prometheus(build(MetricsRegistry()))
    ref_text = r_render(build(RRegistry()))
    assert _same_families(parse_exposition(ref_text), r_parse(port_text))
    assert _same_families(parse_exposition(port_text), r_parse(ref_text))
    with pytest.raises(ValueError):
        parse_exposition("this is not { exposition")


@pytest.mark.parametrize("values", [(), (0.1,), (0.05, 0.3, 0.3, 2.0,
                                                  9.0, 40.0, 1e6)])
def test_histogram_cumulative_matches_reference(values):
    h, rh = Histogram(), RHistogram()
    for v in values:
        h.observe(v)
        rh.observe(v)
    assert h.cumulative() == rh.cumulative()


# ---------------------------------------------------------------------------
# Records and spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rec", [
    {"t": 0, "kind": "train", "step": 1},
    {"kind": "nope"},
    {"t": 1.5, "step": 0},
    {"t": 0, "kind": "span", "step": -1, "name": "x", "ms": 1.0},
    {"t": 0, "kind": "trian", "step": 2, "extra": [1]},
    {},
])
def test_validate_record_matches_reference(rec):
    assert validate_record(rec) == r_validate(rec)
    assert ENVELOPE == ("t", "kind", "step")


def _nest(rec, current):
    """Open a fixed tree of spans; returns the paths seen inside."""
    seen = []
    with rec.span("outer"):
        seen.append(current())
        with rec.span("inner", rule="phocas"):
            seen.append(current())
            with rec.span("leaf", step_num=3):
                seen.append(current())
        seen.append(current())
    with pytest.raises(RuntimeError):
        with rec.span("boom"):
            seen.append(current())
            raise RuntimeError("x")
    seen.append(current())
    return seen


def test_span_nesting_matches_reference():
    rec = Recorder(registry=MetricsRegistry(), trace=True)
    ref = RRecorder(registry=RRegistry(), trace=True)
    assert _nest(rec, current_path) == _nest(ref, r_current_path) == [
        "outer", "outer/inner", "outer/inner/leaf", "outer", "boom", ""]
    got = parse_exposition(rec.snapshot())["repro_span_ms"]["samples"]
    want = r_parse(ref.snapshot())["repro_span_ms"]["samples"]
    assert [(s, lab) for s, lab, _ in got if s.endswith("_count")] == \
        [(s, lab) for s, lab, _ in want if s.endswith("_count")]


def test_module_span_binds_the_default_recorder():
    assert span("x") is NULL_SPAN
    rec = Recorder(registry=MetricsRegistry(), trace=True)
    set_default_recorder(rec)
    try:
        with span("prefill", step_num=0, batch=2) as sp:
            assert current_path() == "prefill"
            assert sp.sync(5) == 5
    finally:
        set_default_recorder(None)
    assert span("x") is NULL_SPAN
    assert rec.registry.get("span_ms", name="prefill", batch=2).count == 1


def test_recorder_close_writes_the_snapshot_once(tmp_path):
    snap = tmp_path / "m.prom"
    rec = make_recorder(None, ObsConfig(metrics_path=str(snap)))
    rec.count("steps", 3)
    rec.close()
    snap.write_text("")
    rec.close()
    assert snap.read_text() == ""
    rec2 = make_recorder(None, ObsConfig(metrics_path=str(snap)))
    rec2.count("steps", 3)
    with rec2.span("agg", rule="phocas"):
        pass
    rec2.close()
    fams = parse_exposition(snap.read_text())
    assert fams["repro_steps"]["samples"][0][2] == 3.0
    assert fams["repro_span_ms"]["type"] == "histogram"


# ---------------------------------------------------------------------------
# The reporter
# ---------------------------------------------------------------------------

def _records(path):
    return read_jsonl(path)


def test_report_matches_reference_on_fixture(capsys):
    records = _records(os.path.join(FIXTURES, "run.jsonl"))
    got, want = summarize(records), r_summarize(records)
    assert got == want
    assert report_render(got) == r_report_render(want)
    assert report_main([os.path.join(FIXTURES, "run.jsonl"), "--kind",
                        "train"]) == 0
    assert "records: train=3" in capsys.readouterr().out


def test_report_matches_reference_on_a_port_run(tmp_path, capsys):
    """A defended run of the port writes the JSONL; both reporters read
    it alike, and the CLI prints its ejection timeline."""
    import dataclasses

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.defense import DefenseConfig
    from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                        run_experiment)
    path = str(tmp_path / "run.jsonl")
    spec = ScenarioSpec.load(os.path.join(REPO, "examples", "scenarios",
                                          "sync_ps_bitflip.json"))
    spec = dataclasses.replace(
        spec, steps=8, telemetry_path=path,
        model=ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=DataSpec(dim=32, batch_per_worker=16, seed=1),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        defense=DefenseConfig(reputation_decay=0.6, warmup_steps=1))
    run_experiment(spec, device="cpu", obs=ObsConfig(profile_cost=False))
    records = _records(path)
    assert all(validate_record(r) == [] for r in records)
    got, want = summarize(records), r_summarize(records)
    assert got == want and got["ejections"] and got["spans"]
    assert report_render(got) == r_report_render(want)
    assert report_main([path]) == 0
    out = capsys.readouterr().out
    assert "ejected (train)" in out and "train_step" in out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert report_main([str(empty)]) == 1


# ---------------------------------------------------------------------------
# The step's cost
# ---------------------------------------------------------------------------

DIMS = (32, 16, 16, 10)


def _mlp_step(defended: bool = False, attack: str = "gaussian"):
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.defense import DefenseConfig
    from repro_torch.models.mlp import build_mlp_model
    from repro_torch.optim import OptConfig
    from repro_torch.train.step import make_train_step
    model = build_mlp_model(DIMS)
    rc = RobustConfig(rule="phocas", b=1, q=1,
                      attack=AttackConfig(name=attack, num_byzantine=1))
    step = make_train_step(model, robust_cfg=rc, opt_cfg=OptConfig(lr=0.1),
                           num_workers=4,
                           defense_cfg=DefenseConfig() if defended else None)
    return model, step


def _batch(m: int, per: int):
    rng = np.random.default_rng(0)
    return {"x": torch.tensor(rng.normal(size=(m, per, DIMS[0])),
                              dtype=torch.float32),
            "y": torch.tensor(rng.integers(0, DIMS[-1], (m, per)))}


@pytest.mark.parametrize("per", [1, 8])
def test_step_flops_equal_a_hand_count(per):
    """FlopCounterMode under the step's vmap(grad) counts each worker's
    matmuls once: per layer 2·B·din·dout forward and, as autograd runs the
    backward, 2·B·din·dout for the weight gradient and (past the first
    layer, whose input needs no gradient) as much for the input's."""
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.optimizers import OptConfig
    m = 4
    model, step = _mlp_step()
    params = model.init(torch.Generator().manual_seed(0))
    opt = init_opt_state(OptConfig(), params)
    gen = torch.Generator().manual_seed(7)
    cost = compiled_cost(step, params, opt, _batch(m, per), gen)
    hand = sum((6 if i else 4) * per * din * dout
               for i, (din, dout) in enumerate(zip(DIMS[:-1], DIMS[1:])))
    assert cost["flops"] == m * hand
    # at least the worker matrix, read by the rule and written once
    d = sum(t.numel() for layer in params.values() for t in layer.values())
    assert cost["bytes"] > 2 * m * d * 4
    # the count drew from a copy of the generator, not from it
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(7).get_state())


def test_step_cost_adds_the_kernels_reckoning(monkeypatch):
    """A kernel launched through ctypes reports its own operations and
    bytes to the open count (stood in for here by the plain version plus a
    report of the kernel's reckoning, as ``build.launch`` adds it)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.phocas import kernel as k1
    from repro_torch.kernels.phocas.ref import phocas_ref
    m, d = 4, 1000

    def launched(u, b):
        build._add_cost(build.matrix_cost("phocas", *u.shape,
                                          u.element_size()))
        with torch.utils._python_dispatch._disable_current_modes():
            return phocas_ref(u, b)

    monkeypatch.setattr(k1, "phocas_ref", launched)
    u = torch.randn(m, d)
    cost = compiled_cost(lambda x: k1.phocas_hopper(x, 1), u)
    assert cost == {"flops": float(m * d),
                    "bytes": float(m * d * 4 + d * 4)}
    assert build.matrix_cost("phocas_counts", m, d, 2) == \
        (4 * m * d, m * d * 2 + d * 4 + m * 4)
    assert build.matrix_cost("krum_gram", m, d, 4) == \
        (m * (m + 1) * d, m * d * 4 + m * m * 4)
    with build.counting_costs() as count:
        build._add_cost((3, 5))
    build._add_cost((1, 1))
    assert count == {"flops": 3, "bytes": 5}
    assert build._COST_COUNT is None


@pytest.mark.parametrize("S,T,causal,window", [
    (7, 7, True, None), (7, 7, True, 3), (5, 9, True, None),
    (9, 5, True, 2), (6, 6, False, None), (6, 8, False, 4)])
def test_flash_cost_counts_the_unmasked_pairs(S, T, causal, window):
    """K6's operations are 4·hd per (query, key) pair and head that the
    plain version's mask keeps."""
    from repro_torch.kernels.build import flash_cost
    q_pos, k_pos = torch.arange(S), torch.arange(T)
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= k_pos[None] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None] > q_pos[:, None] - window
    B, H, Kv, hd = 2, 4, 2, 64
    ops, nbytes = flash_cost(B, S, T, H, Kv, hd, 2, causal, window)
    assert ops == 4 * hd * B * H * int(mask.sum())
    assert nbytes == (2 * B * S * H * hd + 2 * B * T * Kv * hd) * 2


def test_step_cost_failure_is_reported_not_raised(capsys):
    def broken(*_):
        raise RuntimeError("no")
    assert compiled_cost(broken, torch.ones(2)) == {}
    assert "step cost not counted: RuntimeError: no" in \
        capsys.readouterr().err


@pytest.mark.parametrize("defended", [False, True])
def test_history_is_the_same_with_profile_cost_on_and_off(defended):
    """The counting call draws from a copy of the attack's generator and
    drops its outputs: the run is bit for bit the run without it."""
    import dataclasses

    from repro_torch.defense import DefenseConfig
    from repro_torch.experiment import ScenarioSpec, run_experiment
    spec = ScenarioSpec.load(os.path.join(REPO, "examples", "scenarios",
                                          "sync_ps_gaussian.json"))
    if defended:
        spec = dataclasses.replace(spec, defense=DefenseConfig())
    runs = [run_experiment(spec, device="cpu",
                           obs=ObsConfig(profile_cost=on))
            for on in (True, False)]
    strip = [[{k: v for k, v in r.items() if k != "wall"}
              for r in res.history] for res in runs]
    assert strip[0] == strip[1]
    for a, b in zip(runs[0].params.values(), runs[1].params.values()):
        for k in a:
            assert torch.equal(a[k], b[k])


# ---------------------------------------------------------------------------
# Device memory and the profiler window
# ---------------------------------------------------------------------------

def test_device_memory_is_empty_on_the_cpu():
    from repro_torch.obs.profile import sample_into
    assert device_memory_stats() == {}
    rec = Recorder(registry=MetricsRegistry())
    sample_into(rec)
    assert list(rec.registry.families()) == []


def test_profile_window_writes_a_chrome_trace(tmp_path, capsys):
    with profile_trace(None):
        pass
    rec = Recorder(registry=MetricsRegistry(), trace=True)
    with profile_trace(str(tmp_path / "p")):
        with rec.span("train_step"):
            torch.ones(8) @ torch.ones(8)
    import json
    with open(tmp_path / "p" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)
    # a window that cannot be written leaves the run unprofiled
    blocker = tmp_path / "file"
    blocker.write_text("")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with profile_trace(str(blocker / "sub")):
            x = 1
    assert x == 1
    assert "profiler window not started" in capsys.readouterr().err
