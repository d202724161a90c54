"""Event bus + metrics registry (port of ``repro/obs/metrics.py``, DESIGN.md
§12).

Two objects:

* :class:`MetricsRegistry` — in-process counters, gauges, and fixed-bucket
  histograms, keyed by ``(name, labels)``.  Pure stdlib.  (The
  reference exports it as a Prometheus-style text snapshot with
  ``obs/export.py``, which comes with ROADMAP queue 1 item 14.)

* :class:`Recorder` — the bus every instrumented path threads: ``emit()``
  (alias ``log()``, signature-compatible with the legacy
  ``TelemetryWriter.log``) fans one record out to the JSONL sinks AND
  mirrors its scalar fields into registry gauges; ``count()`` /
  ``gauge()`` update metrics directly; ``span()`` returns
  a timed context manager (``obs/trace.py``) that lands wall-times in the
  ``span_ms`` histogram.  A disabled Recorder (no sinks, no registry) costs
  one attribute check per call and allocates nothing — hot loops call it
  unconditionally, exactly like the old no-path TelemetryWriter.

The legacy ``defense/telemetry.TelemetryWriter`` survives unchanged as the
JSONL *sink backend*: the Recorder writes through it, so the on-disk format
(one ``{"t", "kind", "step", ...}`` record per line) and every existing
``read_jsonl`` consumer keep working.
"""
from __future__ import annotations

import dataclasses
import numbers
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs.schema import check_kind

# Default wall-time buckets (milliseconds): sub-ms kernel calls up through
# multi-second compile-included steps, roughly 3x apart.
DEFAULT_MS_BUCKETS = (0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
                      1000.0, 3000.0, 10000.0)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, object]) -> LabelsKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone event count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        self.value += n


class Gauge:
    """Last-written point-in-time value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: a bucket's upper bound
    ``le`` is inclusive; an implicit +Inf bucket catches the overflow)."""
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing and non-empty, got {bounds}")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)     # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect_left: v == bounds[i] lands IN bucket i (le inclusive).
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metric families, each holding one child per label set."""

    def __init__(self):
        # name -> (type_name, {labels_key: metric}, extra ctor args)
        self._families: Dict[str, tuple] = {}

    def _child(self, type_name: str, name: str, labels: Dict[str, object],
               ctor_args: tuple = ()):
        fam = self._families.get(name)
        if fam is None:
            fam = (type_name, {}, ctor_args)
            self._families[name] = fam
        elif fam[0] != type_name:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam[0]}, not {type_name}")
        key = _labels_key(labels)
        child = fam[1].get(key)
        if child is None:
            child = _KINDS[type_name](*fam[2])
            fam[1][key] = child
        return child

    # The metric-name parameter is positional-only so "name" stays legal
    # as a *label* key — span paths land in a "name" label.

    def counter(self, name: str, /, **labels) -> Counter:
        return self._child("counter", name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._child("gauge", name, labels)

    def histogram(self, name: str, /,
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._child("histogram", name, labels, (tuple(buckets),))

    def families(self):
        """Sorted ``(name, type_name, [(labels_key, metric), ...])`` rows
        — the exposition iteration order, deterministic by construction."""
        for name in sorted(self._families):
            type_name, children, _ = self._families[name]
            yield name, type_name, sorted(children.items())

    def get(self, name: str, /, **labels):
        """The existing child metric, or None (never creates)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam[1].get(_labels_key(labels))


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability switches a launch CLI maps its flags onto.

    ``enabled`` turns the metrics registry on; ``trace`` additionally arms
    span timing (host wall-clock with ``torch.cuda.synchronize`` at span
    close — see obs/trace.py for the async-dispatch contract).  The
    reference's ``metrics_path`` (exposition snapshot), ``profile_dir``
    (profiler window) and ``profile_cost`` (compiled-step cost) come with
    ROADMAP queue 1 item 14: :func:`make_recorder` refuses the first two,
    and nothing reads the third.
    """
    enabled: bool = True
    trace: bool = True
    metrics_path: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_cost: bool = True


def _scalar(v) -> Optional[float]:
    """Float view of a plain/0-d numeric value, else None (cheap checks
    first: the disabled path must not import numpy per field)."""
    if isinstance(v, bool):
        return None
    if isinstance(v, numbers.Number):
        return float(v)
    shape = getattr(v, "shape", None)
    if shape == ():
        try:
            return float(v)
        except (TypeError, ValueError):
            return None
    return None


class Recorder:
    """The observability bus: JSONL sinks + metrics registry + tracer.

    ``sinks`` are TelemetryWriter-shaped objects (anything with
    ``log(kind, step, **fields)``); ``owned`` sinks are closed with the
    Recorder.  ``registry=None`` disables metrics, ``trace=False`` disables
    span timing — with both off and no sinks, every method is a cheap
    no-op, which is the mode hot loops run in by default.
    """

    def __init__(self, sinks: Sequence = (), registry:
                 Optional[MetricsRegistry] = None, trace: bool = False,
                 owned: Sequence = ()):
        self._sinks = list(sinks)
        self._owned = list(owned)
        self.registry = registry
        self.trace_enabled = bool(trace) and registry is not None
        self._closed = False

    @property
    def metrics_enabled(self) -> bool:
        return self.registry is not None

    # -- the event bus -----------------------------------------------------

    def _write(self, kind: str, step: int, **fields) -> None:
        """Sink-only write (no gauge mirroring) — the close-time registry
        dump and span records use this to avoid re-entering the registry."""
        check_kind(kind)
        for sink in self._sinks:
            sink.log(kind, step, **fields)

    def emit(self, kind: str, step: int, **fields) -> None:
        """One record onto the bus: validated kind, fanned out to every
        JSONL sink (legacy on-disk format), scalar fields mirrored into
        ``<kind>_<field>`` gauges when metrics are on."""
        if not (self._sinks or self.registry is not None):
            return
        self._write(kind, step, **fields)
        reg = self.registry
        if reg is not None:
            for k, v in fields.items():
                s = _scalar(v)
                if s is not None:
                    reg.gauge(f"{kind}_{k}").set(s)

    # Signature-compatible with TelemetryWriter.log, so a Recorder drops
    # into every call site that used to take the raw writer.
    log = emit

    # -- direct metric updates --------------------------------------------

    def count(self, name: str, n: float = 1.0, **labels) -> None:
        if self.registry is not None:
            self.registry.counter(name, **labels).inc(n)

    def gauge(self, name: str, value: float, **labels) -> None:
        if self.registry is not None:
            self.registry.gauge(name, **labels).set(value)

    def span(self, name: str, step_num: Optional[int] = None, **labels):
        """A timed span context manager, or the shared zero-cost no-op
        when tracing is off (``rec.span(...) is rec.span(...)`` then —
        nothing is allocated per call)."""
        from repro_torch.obs.trace import NULL_SPAN, Span
        if not self.trace_enabled:
            return NULL_SPAN
        return Span(self, name, labels, step_num=step_num)

    # trace.Span calls back here when a span closes.
    def _span_done(self, path: str, ms: float, labels: Dict[str, object],
                   step_num: Optional[int]) -> None:
        if self.registry is not None:
            self.registry.histogram(
                "span_ms", DEFAULT_MS_BUCKETS,
                name=path, **labels).observe(ms)
        if self._sinks:
            self._write("span", step_num if step_num is not None else -1,
                        name=path, ms=ms, labels=dict(labels))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Flush: dump the registry as ``metric`` records onto the JSONL
        sinks, close owned sinks."""
        if self._closed:
            return
        self._closed = True
        if self.registry is not None and self._sinks:
            for name, type_name, children in list(self.registry.families()):
                for labels_key, m in children:
                    value = (m.sum if type_name == "histogram" else m.value)
                    self._write("metric", -1, name=name, type=type_name,
                                value=float(value),
                                labels=dict(labels_key))
        for sink in self._owned:
            sink.close()
        self._owned = []

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


#: Shared disabled recorder — the "None telemetry" of the bus world.
DISABLED = Recorder()


def as_recorder(obj) -> Recorder:
    """Adapt a telemetry argument to the bus: a Recorder passes through,
    a TelemetryWriter becomes a sink-only Recorder (not owned — the caller
    keeps closing it), None becomes the shared disabled Recorder."""
    if obj is None:
        return DISABLED
    if isinstance(obj, Recorder):
        return obj
    return Recorder(sinks=(obj,))


def make_recorder(telemetry_path: Optional[str] = None,
                  obs: Optional[ObsConfig] = None) -> Recorder:
    """The Recorder for one run: a JSONL sink when ``telemetry_path`` is
    set (owned — closed with the Recorder), a metrics registry + tracer
    when ``obs.enabled``.  Both off returns a disabled (but fresh,
    independently closeable) Recorder."""
    from repro_torch.defense.telemetry import TelemetryWriter
    if obs is not None and (obs.metrics_path or obs.profile_dir):
        from repro_torch.experiment.spec import not_ported
        raise not_ported("the metrics snapshot and profiler window "
                         "(ObsConfig.metrics_path / profile_dir)", "item 14")
    sinks, owned = [], []
    if telemetry_path:
        writer = TelemetryWriter(telemetry_path)
        sinks.append(writer)
        owned.append(writer)
    registry = MetricsRegistry() if (obs is not None and obs.enabled) \
        else None
    return Recorder(sinks=sinks, registry=registry,
                    trace=obs.trace if obs is not None else False,
                    owned=owned)
