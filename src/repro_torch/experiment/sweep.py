"""Grid sweeps over :class:`ScenarioSpec` axes + scenario-level result
caching (port of ``repro/experiment/sweep.py``, DESIGN.md §9).

A sweep is the cartesian product of dotted-path axes over a base spec:

    specs = sweep(base, {"robust.rule": ["phocas", "trmean"],
                         "attack.num_byzantine": [0, 4, 8],
                         "num_workers": [20, 40]})

Each dotted path addresses a (possibly nested) spec field — frozen
dataclasses are rebuilt with ``dataclasses.replace`` along the path, dict
fields (``topology_params``, ``schedule_params``) get a key set — so the
grid is expressed against the same declarative surface ``run_experiment``
consumes, and every cell is ``validate()``-checked up front (a bad cell
fails before any cell runs).

Caching keys on the *content* of the spec: :func:`scenario_key` is the
SHA-256 of the canonical ``to_json()`` (sorted keys — byte-identical specs
iff equal), so :func:`run_cached` replays a previously-run cell from its
JSON summary instead of re-running it.  Cache hits return an
:class:`ExperimentResult` with ``params=None`` (params are not persisted —
the cache stores *summaries*, not checkpoints; use ``checkpoint_path`` for
weights).  The key is the reference's for the same spec: both packages
write the same canonical JSON.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Sequence

from repro_torch.experiment.runner import ExperimentResult, run_experiment
from repro_torch.experiment.spec import ScenarioSpec


def _replace_path(obj: Any, path: str, value: Any) -> Any:
    """Rebuild ``obj`` with the dotted ``path`` set to ``value`` —
    dataclasses via ``dataclasses.replace``, dicts via key assignment."""
    head, _, rest = path.partition(".")
    if isinstance(obj, dict):
        if not rest:
            return {**obj, head: value}
        if head not in obj:
            raise KeyError(f"dict field has no key {head!r} to descend into")
        return {**obj, head: _replace_path(obj[head], rest, value)}
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot descend into {type(obj).__name__} "
                        f"at {path!r}")
    names = {f.name for f in dataclasses.fields(obj)}
    if head not in names:
        raise KeyError(f"{type(obj).__name__} has no field {head!r} "
                       f"(axes use spec paths like 'robust.rule')")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: _replace_path(getattr(obj, head), rest, value)})


def apply_overrides(spec: ScenarioSpec,
                    overrides: Dict[str, Any]) -> ScenarioSpec:
    """One grid cell: ``spec`` with every dotted-path override applied."""
    for path, value in overrides.items():
        spec = _replace_path(spec, path, value)
    return spec


def sweep(base: ScenarioSpec, axes: Dict[str, Sequence[Any]],
          *, validate: bool = True,
          name_cells: bool = True) -> List[ScenarioSpec]:
    """Cartesian product of ``axes`` over ``base`` (insertion-ordered, last
    axis fastest).  Each cell's ``name`` gets a ``path=value`` suffix so
    telemetry/results stay attributable; ``validate=True`` (default) checks
    every cell before returning — the whole grid fails fast on one bad cell.
    """
    cells: List[Dict[str, Any]] = [{}]
    for path, values in axes.items():
        cells = [{**cell, path: v} for cell in cells for v in values]
    out: List[ScenarioSpec] = []
    for cell in cells:
        spec = apply_overrides(base, cell)
        if name_cells and cell:
            suffix = ",".join(f"{p.rsplit('.', 1)[-1]}={v}"
                              for p, v in cell.items())
            spec = dataclasses.replace(spec, name=f"{spec.name}[{suffix}]")
        if validate:
            spec.validate()
        out.append(spec)
    return out


def scenario_key(spec: ScenarioSpec) -> str:
    """Content hash of the canonical spec JSON — equal iff the scenarios
    are byte-identical under ``to_json()`` (sorted keys)."""
    return hashlib.sha256(spec.to_json().encode()).hexdigest()


def run_cached(spec: ScenarioSpec, cache_dir: str,
               runner=run_experiment, **runner_kwargs) -> ExperimentResult:
    """Run ``spec`` (via ``runner``), or replay its stored summary.

    The cache entry is ``<cache_dir>/<scenario_key>.json`` holding the full
    spec (provenance + collision check) plus history/final_metrics/
    wall_time.  On a hit the stored spec must round-trip to the same
    canonical JSON — a mismatch means a hash collision or a hand-edited
    file, and raises rather than silently returning the wrong scenario.
    """
    key = scenario_key(spec)
    path = os.path.join(cache_dir, f"{key}.json")
    if os.path.exists(path):
        with open(path) as f:
            entry = json.load(f)
        stored = ScenarioSpec.from_dict(entry["spec"])
        if stored.to_json() != spec.to_json():
            raise ValueError(
                f"cache entry {path} holds a different scenario "
                f"({stored.name!r}); delete it and re-run")
        return ExperimentResult(
            spec=stored, history=entry["history"], params=None,
            final_metrics=entry["final_metrics"],
            wall_time=entry["wall_time"])
    result = runner(spec, **runner_kwargs)
    os.makedirs(cache_dir, exist_ok=True)
    entry = {"key": key, "spec": spec.to_dict(),
             "history": result.history,
             "final_metrics": result.final_metrics,
             "wall_time": result.wall_time}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=2, sort_keys=True, default=_tolerant)
    os.replace(tmp, path)
    return result


def run_sweep(base: ScenarioSpec, axes: Dict[str, Sequence[Any]],
              *, cache_dir: str = "", runner=run_experiment,
              ) -> List[ExperimentResult]:
    """``sweep`` + execute: every cell through :func:`run_cached` when
    ``cache_dir`` is set, plain ``runner`` otherwise."""
    specs = sweep(base, axes)
    if cache_dir:
        return [run_cached(s, cache_dir, runner=runner) for s in specs]
    return [runner(s) for s in specs]


def _tolerant(obj: Any):
    """JSON fallback for numpy/torch scalars that leak into history
    records."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        return tolist()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")
