"""The port's package-level import surface against the reference's.

Every public name that a ``repro.<pkg>/__init__.py`` binds (its
``__all__`` where it has one, else the names its imports, definitions and
assignments bind, less those it deletes) resolves in ``repro_torch.<pkg>``,
one case a subpackage; the ``from repro... import ...`` lines of the
examples resolve with ``repro_torch`` in their place (read with ``ast``,
nothing run).  The functions and properties that came with the exports
are held to the reference's on the same inputs: ``get_aggregator`` for
every registered rule on one seeded (20, 64) matrix at the tolerance the
rule's own parity tests use, ``ExperimentResult.eval_curve``,
``fault_kind_names``, ``Histogram.quantile`` (its ``ValueError`` too) and
``Recorder.observe``/``enabled``/``disabled``.
"""
import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import _assert_phocas_close

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = REPO / "src" / "repro"

# Names a reference ``__init__`` exports that the port cannot have, with
# the reason.  None so far: ``dist/compat.py``'s JAX shims, which have no
# counterpart, are installed by ``repro/__init__.py`` under a private name
# and exported by no ``__init__``.
NO_COUNTERPART = {}


def _packages():
    return sorted(".".join(p.parent.relative_to(REFERENCE.parent).parts)
                  for p in REFERENCE.glob("**/__init__.py"))


def _exported(init: pathlib.Path) -> list:
    """The public names ``init`` binds, as the module docstring says."""
    bound, deleted, listed = [], set(), None
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) or isinstance(node, ast.Import):
            bound += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            bound.append(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    listed = list(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    bound.append(t.id)
        elif isinstance(node, ast.Delete):
            deleted |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
    if listed is not None:
        return listed
    return [n for n in bound if not n.startswith("_") and n not in deleted]


def _resolves(module: str, name: str) -> bool:
    mod = importlib.import_module(module)
    if hasattr(mod, name):
        return True
    try:                            # a submodule bound by the import
        importlib.import_module(f"{module}.{name}")
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("pkg", _packages())
def test_every_exported_name_resolves_in_the_port(pkg):
    init = REFERENCE.parent.joinpath(*pkg.split("."), "__init__.py")
    port = "repro_torch" + pkg[len("repro"):]
    missing = [n for n in _exported(init)
               if (pkg, n) not in NO_COUNTERPART and not _resolves(port, n)]
    assert not missing, f"{port} lacks {missing}"


@pytest.mark.parametrize("example", sorted(
    p.name for p in (REPO / "examples").glob("*.py")))
def test_the_examples_imports_resolve_in_the_port(example):
    tree = ast.parse((REPO / "examples" / example).read_text())
    lines = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and n.module and n.module.split(".")[0] == "repro"]
    assert lines
    for node in lines:
        port = "repro_torch" + node.module[len("repro"):]
        for alias in node.names:
            assert _resolves(port, alias.name), (port, alias.name)


# rule -> tolerance of its parity tests (test_torch_aggregators.py,
# test_torch_krum.py, test_torch_vector_rules.py, test_torch_compress.py);
# None: equal bit for bit
RULE_ATOL = {"mean": 1e-4, "median": 1e-4, "trmean": 1e-4, "phocas": 1e-4,
             "krum": None, "multikrum": 1e-5, "geomedian": 1e-4,
             "mediam": 1e-5, "mom": 1e-5, "signvote": None}


def test_every_registered_rule_has_a_tolerance():
    from repro_torch.core import registry
    assert set(registry.available_rules()) == set(RULE_ATOL)


@pytest.mark.parametrize("name", sorted(RULE_ATOL))
def test_get_aggregator_matches_the_reference(name):
    from repro.core import get_aggregator as r_get
    from repro_torch.core import get_aggregator
    u = (10.0 * np.random.default_rng(3).standard_normal((20, 64))
         ).astype(np.float32)
    u[:4] += 40.0                                   # q outliers
    kw = dict(b=4, q=4)
    got = get_aggregator(name, **kw)(torch.tensor(u)).numpy()
    want = np.asarray(r_get(name, **kw)(jnp.asarray(u)))
    atol = RULE_ATOL[name]
    if atol is None:
        np.testing.assert_array_equal(got, want)
    elif name == "phocas":
        _assert_phocas_close(jnp.asarray(u), 4, got, want, atol=atol)
    else:
        rtol = 1e-4 if name == "geomedian" else 0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_get_aggregator_defaults_to_the_plain_path():
    from repro_torch.core import (COORDINATE_WISE, VECTOR_WISE,
                                  get_aggregator, make_rule)
    from repro.core import COORDINATE_WISE as R_CW, VECTOR_WISE as R_VW
    assert (COORDINATE_WISE, VECTOR_WISE) == (R_CW, R_VW)
    reduce = get_aggregator("phocas", b=1)
    assert reduce.__self__.backend == "xla"
    assert make_rule("phocas").backend == "auto"


def test_eval_curve_and_fault_kind_names_match_the_reference():
    from repro.experiment.runner import ExperimentResult as RResult
    from repro.faults import fault_kind_names as r_kinds
    from repro_torch.experiment.runner import ExperimentResult
    from repro_torch.faults import fault_kind_names
    history = [{"step": 0, "loss": 2.0}, {"step": 5, "loss": 1.0,
                                          "eval": 0.5},
               {"step": 9, "eval": 0.75}]
    assert (ExperimentResult(None, history, None).eval_curve
            == RResult(None, history, None).eval_curve
            == [(5, 0.5), (9, 0.75)])
    assert fault_kind_names() == r_kinds()


def test_histogram_quantile_matches_the_reference():
    from repro.obs.metrics import Histogram as RHistogram
    from repro_torch.obs.metrics import Histogram
    values = np.random.default_rng(0).lognormal(1.0, 2.0, 200)
    got, want = Histogram(), RHistogram()
    assert got.quantile(0.5) == want.quantile(0.5) == 0.0
    for v in values:
        got.observe(v)
        want.observe(v)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q), q
    for h in (got, want):
        with pytest.raises(ValueError, match=r"quantile must be in \[0, 1\]"):
            h.quantile(1.5)


def test_recorder_observe_matches_the_reference():
    from repro.obs.metrics import MetricsRegistry as RRegistry
    from repro.obs.metrics import Recorder as RRecorder
    from repro_torch.obs.metrics import MetricsRegistry, Recorder
    assert not Recorder.disabled().enabled
    assert not RRecorder.disabled().enabled
    got, want = Recorder(registry=MetricsRegistry()), RRecorder(
        registry=RRegistry())
    assert got.enabled and want.enabled
    for rec in (got, want):
        for v in (0.05, 2.0, 2.0, 250.0, 1e9):
            rec.observe("decode_ms", v, phase="decode")
        rec.observe("tiny", 0.5, buckets=(1.0, 2.0))
    for name, buckets, labels in (("decode_ms", None, {"phase": "decode"}),
                                  ("tiny", (1.0, 2.0), {})):
        args = (name,) if buckets is None else (name, buckets)
        h, r = (got.registry.histogram(*args, **labels),
                want.registry.histogram(*args, **labels))
        assert (h.bounds, h.counts, h.sum, h.count) == (
            r.bounds, r.counts, r.sum, r.count)
    Recorder.disabled().observe("nothing", 1.0)     # a no-op
