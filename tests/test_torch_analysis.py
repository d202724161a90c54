"""repro_torch.analysis, the port's static-analysis gate, against its
seeded fixtures and against the reference's ``repro.analysis``.

The port's fixtures (``tests/fixtures/torch_analysis/``) carry an inline
``VIOLATION <RULE>`` marker ON every line a finding must anchor to; the
expected ``(rule, line)`` pairs are read from the markers.  The parity
tests run the same inputs through both packages: noqa parsing,
``collect_files``, CONTRACT010 on the reference's own fixtures, the
registry audits at head, and the same metadata flip on one registered rule
in each package.
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from repro.analysis import contracts as ref_contracts
from repro.analysis import engine as ref_engine
from repro.analysis import findings as ref_findings
from repro.analysis import telemetry_kinds as ref_telemetry_kinds
from repro_torch.analysis import (axes, contracts, engine, findings, prng,
                                  telemetry_kinds)
from repro_torch.analysis.findings import Finding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_analysis")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
# The port's files, as chip_smoke.py's phase 14 hands them to the gate.
PORT_PATHS = ["src/repro_torch", "chip_smoke.py", "tools",
              *sorted(os.path.relpath(os.path.join(REPO, "tests", f), REPO)
                      for f in os.listdir(os.path.join(REPO, "tests"))
                      if re.fullmatch(r"(test_torch_.*|torch_.*_ranks)\.py",
                                      f))]

_MARK_RE = re.compile(r"VIOLATION (\w+)")


def _fx(name: str) -> str:
    return os.path.join(FIXTURES, name)


def _expected(path):
    """(rule, line) pairs from the fixture's VIOLATION markers."""
    out = set()
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            for m in _MARK_RE.finditer(line):
                out.add((m.group(1), i))
    return out


def _found(found):
    return {(f.rule, f.line) for f in found}


def _analyze(path):
    with open(path) as fh:
        return engine.analyze_file(path, fh.read())


# ---------------------------------------------------------------------------
# The port's fixtures: every seeded violation caught at its line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stem", ["prng003", "axis001", "axis002",
                                  "pallas002", "contract010"])
def test_ast_fixture_violations_exact(stem):
    path = _fx(f"{stem}_violation.py")
    assert _found(_analyze(path)) == _expected(path)


@pytest.mark.parametrize("stem", ["prng003", "prng004", "axis001", "axis002",
                                  "pallas002", "contract010"])
def test_ast_fixture_clean_twins(stem):
    path = _fx(f"{stem}_clean.py")
    assert _analyze(path) == []
    # the clean twins stay clean under the library-code seed rules too
    with open(path) as fh:
        tree = ast.parse(fh.read())
    assert prng.analyze(path, tree, library_code=True) == []


def test_prng004_fires_only_in_library_code():
    path = _fx("prng004_violation.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    assert _found(prng.analyze(path, tree, library_code=True)) \
        == _expected(path)
    assert prng.analyze(path, tree, library_code=False) == []
    assert engine.is_library_code(
        os.path.join(REPO, "src", "repro_torch", "dist", "launch.py"))
    assert not engine.is_library_code(path)


@pytest.mark.parametrize("kind", ["rule", "attack", "topology", "codec"])
def test_contract_fixture_violations_exact(kind):
    path = _fx(f"contract_{kind}_violations.py")
    assert _found(contracts.check_module(path)) == _expected(path)


@pytest.mark.parametrize("kind", ["rule", "attack", "topology", "codec"])
def test_contract_fixture_clean_twins(kind):
    assert contracts.check_module(_fx(f"contract_{kind}_clean.py")) == []


def test_module_scan_registers_nothing():
    from repro_torch.compress.spec import available_codecs
    from repro_torch.core import registry
    from repro_torch.experiment.topology import available_topologies
    before = (registry.available_rules(), registry.available_attacks(),
              available_topologies(), available_codecs())
    for kind in ("rule", "attack", "topology", "codec"):
        contracts.check_module(_fx(f"contract_{kind}_violations.py"))
    assert (registry.available_rules(), registry.available_attacks(),
            available_topologies(), available_codecs()) == before
    assert not [m for m in sys.modules
                if m.startswith("_repro_torch_analysis_scan_")]


def test_noqa_suppression_fixture():
    path = _fx("noqa_suppressed.py")
    assert _found(engine.run_analysis([path], contracts=False)) \
        == _expected(path)


# ---------------------------------------------------------------------------
# The two drifts the gate found in the port, repaired
# ---------------------------------------------------------------------------

def test_mediam_inherits_no_kernel_hook():
    """mediam declares no kernel and, since the hooks moved onto
    trmean's and phocas's own base, inherits none (CONTRACT002)."""
    from repro_torch.core.registry import (AggregatorRule, RuleParams,
                                           get_rule, make_rule)
    mediam = get_rule("mediam")
    assert contracts._defining_class(mediam, "_reduce_kernel") \
        is AggregatorRule
    assert contracts._check_rule(mediam) == []
    with pytest.raises(ValueError, match="declares no kernel"):
        make_rule("mediam", RuleParams(b=1, backend="pallas"))
    for name, kind in (("trmean", "trmean"), ("phocas", "phocas")):
        cls = get_rule(name)
        assert cls.has_kernel and contracts._check_rule(cls) == []
        names, unresolved = contracts._ops_names(
            cls, contracts._own_functions(cls, AggregatorRule))
        assert sorted(set(names)) == [kind, f"{kind}_with_counts"]
        assert unresolved == []


class _Reads(dict):
    """topology_params that records each ``get`` and its default."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def get(self, key, default=None):
        self.seen[key] = default
        return default


class _StopAfterParams(Exception):
    pass


class _Plan:
    def __init__(self):
        self.topology_params = _Reads()

    @property
    def model(self):
        raise _StopAfterParams


def _serve_reads(topology_cls):
    plan = _Plan()
    with pytest.raises(_StopAfterParams):
        topology_cls().run(plan)
    return plan.topology_params.seen


def test_serve_reads_each_param_literally_with_the_reference_defaults():
    """serve reads its eight keys as literal ``plan.topology_params.get``
    calls (CONTRACT006 sees them), with the reference's defaults."""
    from repro.experiment.topology import get_topology as ref_get
    from repro_torch.experiment.topology import get_topology
    from repro_torch.core.registry import available_attacks
    serve = get_topology("serve")
    assert contracts._check_topology(serve, available_attacks()) == []
    reads = _serve_reads(serve)
    assert set(reads) == set(serve.param_names)
    assert reads == _serve_reads(ref_get("serve"))


# ---------------------------------------------------------------------------
# Live checks: PALLAS003 and CONTRACT009
# ---------------------------------------------------------------------------

def test_pallas003_holds_at_head_and_fires_on_a_python_cap(monkeypatch):
    from repro_torch.kernels import build
    assert contracts._check_kernel_caps() == []
    monkeypatch.setattr(build, "WARP_SORT_MAX_M", 2048)
    found = contracts._check_kernel_caps()
    assert [f.rule for f in found] == ["PALLAS003"]
    assert "kWarpSortMaxM" in found[0].message


@pytest.mark.parametrize("fname, old, new, cap", [
    ("selection.cuh", "kRegisterMaxM = 64", "kRegisterMaxM = 48",
     "kRegisterMaxM"),
    ("selection.cuh", "m <= 48 ? 48 : 64", "m <= 40 ? 40 : 64",
     "next_bucket"),
    ("krum_gram.cu", "kGramTile = 256", "kGramTile = 128", "kGramTile"),
    ("selection.cuh", "kBF16 = 2", "kBF16 = 3", "kBF16"),
])
def test_pallas003_fires_on_a_changed_cuda_source(tmp_path, monkeypatch,
                                                  fname, old, new, cap):
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    text = (csrc / fname).read_text()
    assert text.count(old) == 1
    (csrc / fname).write_text(text.replace(old, new))
    monkeypatch.setattr(build, "CSRC", csrc)
    found = contracts._check_kernel_caps()
    assert found and all(f.rule == "PALLAS003" for f in found)
    assert any(cap in f.message for f in found)


def test_pallas003_fires_on_a_missing_source(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    (csrc / "trmean_counts.cu").unlink()
    monkeypatch.setattr(build, "CSRC", csrc)
    found = contracts._check_kernel_caps()
    assert [f.rule for f in found] == ["PALLAS003"]
    assert "trmean_counts" in found[0].message


@pytest.mark.parametrize("op, sources", [
    ("trmean", {"trmean"}), ("phocas", {"phocas"}),
    ("trmean_with_counts", {"trmean_counts"}),
    ("phocas_with_counts", {"phocas_counts"}),
    ("pairwise_sq_dists", {"krum_gram"}), ("krum", {"krum_gram"}),
    ("multikrum", {"krum_gram"}), ("flash_attention", {"flash_attn"}),
])
def test_each_ops_entry_point_reaches_its_kernel_source(op, sources):
    assert contracts.launched_sources("repro_torch.kernels.ops", op) \
        == sources


def test_contract009_fires_when_the_allocator_takes_block_0_back(
        monkeypatch):
    from repro_torch.serve import cache
    assert contracts._check_serve_invariants() == []
    monkeypatch.setattr(cache.BlockAllocator, "free", lambda self, b: None)
    assert [f.rule for f in contracts._check_serve_invariants()] \
        == ["CONTRACT009"]


# ---------------------------------------------------------------------------
# Parity with the reference's gate
# ---------------------------------------------------------------------------

NOQA_LINES = [
    "x = 1",
    "x = 1  # repro: noqa",
    "x  # repro: noqa[PRNG003] reason",
    "x  # repro: noqa[PRNG003, AXIS002]",
    "x  #repro:noqa[CONTRACT010,PALLAS002]  -- audited",
    "x  # repro: noqa[] empty",
    "x  # noqa: E501",
]


def test_noqa_parsing_matches_the_reference():
    for line in NOQA_LINES:
        assert findings.noqa_rules_of_line(line) \
            == ref_findings.noqa_rules_of_line(line), line
    assert findings.noqa_rules_of_line(NOQA_LINES[3]) \
        == frozenset({"PRNG003", "AXIS002"})


@pytest.mark.parametrize("paths", [["tests"], ["src"],
                                   ["tests/fixtures/analysis/prng001_"
                                    "violation.py", "tests"]])
def test_collect_files_matches_the_reference(paths):
    paths = [os.path.join(REPO, p) for p in paths]
    files, saw_dir = engine.collect_files(paths)
    assert (files, saw_dir) == ref_engine.collect_files(paths)
    walked = [f for f in files if f not in paths]
    assert walked and not any("fixtures" in f for f in walked)


@pytest.mark.parametrize("stem", ["contract010_violation",
                                  "contract010_clean"])
def test_contract010_matches_the_reference_on_its_fixtures(stem):
    path = os.path.join(REF_FIXTURES, f"{stem}.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    port = _found(telemetry_kinds.analyze(path, tree))
    assert port == _found(ref_telemetry_kinds.analyze(path, tree))
    assert port == _expected(path)
    assert telemetry_kinds.known_kinds() \
        == ref_telemetry_kinds.known_kinds()


def test_both_registries_are_clean_at_head():
    assert contracts.check_registry() == []
    assert ref_contracts.check_registry() == []


@pytest.mark.parametrize("flag", ["emits_scores", "has_kernel", "fused_gate",
                                  "supports_streaming", "uses_b"])
def test_a_metadata_flip_gives_the_same_finding_in_both(monkeypatch, flag):
    from repro.core import registry as ref_registry
    from repro_torch.core import registry
    rule = "mean"
    rules = {}
    for reg, check in ((registry, contracts.check_registry),
                       (ref_registry, ref_contracts.check_registry)):
        cls = reg.get_rule(rule)
        monkeypatch.setattr(cls, flag, not getattr(cls, flag))
        rules[reg.__name__] = {f.rule for f in check()
                               if repr(rule) in f.message}
        monkeypatch.undo()
    port, ref = rules.values()
    assert port and port == ref


def test_block_tokens_and_axis_vocab_match_the_reference():
    from repro.dist.sharding import AXIS_VOCAB as REF_VOCAB
    from repro.serve.cache import DEFAULT_BLOCK_TOKENS
    from repro_torch.dist.sharding import AXIS_VOCAB
    from repro_torch.serve.cache import BLOCK_TOKENS
    assert BLOCK_TOKENS == DEFAULT_BLOCK_TOKENS
    assert AXIS_VOCAB == REF_VOCAB
    assert axes.axis_vocabulary() == frozenset(AXIS_VOCAB)
    # the import-failure fallback must not drift from the real vocabulary
    assert axes._DEFAULT_VOCAB == frozenset(AXIS_VOCAB)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_jsonl_reads_back_as_telemetry(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    from repro_torch.defense.telemetry import read_jsonl
    from repro_torch.obs.schema import validate_record
    out = tmp_path / "findings.jsonl"
    path = _fx("contract_rule_violations.py")
    rc = main(["--scan-modules", path, "--jsonl", str(out)])
    assert rc == 1
    records = read_jsonl(str(out))
    assert records and all(r["kind"] == "analysis" for r in records)
    assert all(validate_record(r) == [] for r in records)
    assert {"t", "kind", "step", "rule", "severity", "path", "line",
            "message", "hint"} <= set(records[0])
    assert {(r["rule"], r["line"]) for r in records} == _expected(path)
    text = capsys.readouterr().out
    assert (f"repro_torch.analysis: {len(records)} error(s), 0 warning(s) "
            "in 1 path(s)") in text


def test_unknown_rule_id_rejected():
    with pytest.raises(ValueError):
        Finding(rule="PRNG001", path="x.py", line=1, message="m")
    with pytest.raises(ValueError):
        Finding(rule="PALLAS001", path="x.py", line=1, message="m")
    f = Finding(rule="PRNG003", path="a.py", line=3, message="m", hint="h")
    assert json.loads(json.dumps(f.to_record())) == {
        "rule": "PRNG003", "severity": "error", "path": "a.py", "line": 3,
        "message": "m", "hint": "h"}


def test_gate_over_the_port_exits_0_with_jax_blocked(tmp_path):
    """``python -m repro_torch.analysis`` over the port's files, as
    chip_smoke.py runs it, with JAX and the reference unimportable."""
    out = tmp_path / "analysis.jsonl"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.argv = ['repro_torch.analysis', *{PORT_PATHS!r},"
            f" '--jsonl', {str(out)!r}]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__', alter_sys=True)\n"
            "finally:\n"
            "    bad = [k for k, v in sys.modules.items() if v is not None\n"
            "           and (k == 'repro' or k.startswith(('repro.', "
            "'jax')))]\n"
            "    assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.analysis: 0 error(s), 0 warning(s)" in proc.stdout
    assert out.read_text() == ""
