"""Prometheus-style text exposition for the obs metrics registry (a copy of
``repro/obs/export.py``: the text format is the contract both packages
write).

One snapshot of a :class:`repro_torch.obs.metrics.MetricsRegistry`, rendered
in the Prometheus text format (version 0.0.4 subset): ``# TYPE`` header per
family, ``name{label="v"} value`` samples, histograms expanded into
cumulative ``_bucket{le="..."}`` series plus ``_sum``/``_count``.  All
series carry the ``repro_`` namespace prefix; names and label keys are
sanitised to the Prometheus charset so span paths like
``engine_step/decode`` survive as label *values* (quoted, escaped) while
never leaking illegal characters into metric names.

``parse_exposition`` is the matching reader — enough of a parser for the
CI smoke test and the golden-file test to assert "snapshot parses and the
core series are present" without a prometheus client dependency.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

PREFIX = "repro_"


def _metric_name(name: str) -> str:
    name = _SANITIZE.sub("_", name)
    if not _NAME_OK.match(name):
        name = "_" + name
    return PREFIX + name


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\"", "\\\"") \
                .replace("\n", "\\n")


def _render_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{_LABEL_SANITIZE.sub("_", k)}="{_escape(v)}"'
                    for k, v in pairs)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry) -> str:
    """The registry's current state as Prometheus exposition text."""
    lines: List[str] = []
    for name, type_name, children in registry.families():
        exp_name = _metric_name(name)
        lines.append(f"# TYPE {exp_name} {type_name}")
        for labels_key, metric in children:
            pairs = list(labels_key)
            if type_name == "histogram":
                cumulative = metric.cumulative()
                for bound, acc in zip(metric.bounds, cumulative):
                    lines.append(
                        f"{exp_name}_bucket"
                        f"{_render_labels(pairs + [('le', _fmt(bound))])}"
                        f" {acc}")
                lines.append(
                    f"{exp_name}_bucket"
                    f"{_render_labels(pairs + [('le', '+Inf')])}"
                    f" {cumulative[-1]}")
                lines.append(f"{exp_name}_sum{_render_labels(pairs)} "
                             f"{_fmt(metric.sum)}")
                lines.append(f"{exp_name}_count{_render_labels(pairs)} "
                             f"{metric.count}")
            else:
                lines.append(f"{exp_name}{_render_labels(pairs)} "
                             f"{_fmt(metric.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_snapshot(registry, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(render_prometheus(registry))


# -- reader ------------------------------------------------------------------

_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)\s*$")
_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return value.replace("\\n", "\n").replace("\\\"", "\"") \
                .replace("\\\\", "\\")


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)        # float("NaN") handles NaN


def parse_exposition(text: str) -> Dict[str, dict]:
    """Decode exposition text into ``{name: {"type": ..., "samples":
    [(series_name, labels_dict, value), ...]}}``.

    Histogram child series (``_bucket``/``_sum``/``_count``) attach to
    their family name.  Raises ValueError on a malformed line, which is
    what makes this usable as a CI "snapshot parses" assertion.
    """
    families: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                families.setdefault(
                    parts[2], {"type": parts[3], "samples": []})
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line {lineno}: {raw!r}")
        series = m.group("name")
        labels = {k: _unescape(v) for k, v in
                  _LABEL_PAIR.findall(m.group("labels") or "")}
        value = _parse_value(m.group("value"))
        fam_name = series
        for suffix in ("_bucket", "_sum", "_count"):
            base = series[:-len(suffix)] if series.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                fam_name = base
                break
        fam = families.setdefault(
            fam_name, {"type": types.get(fam_name, "untyped"),
                       "samples": []})
        fam["samples"].append((series, labels, value))
    return families
