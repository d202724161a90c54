"""repro_torch.obs — unified tracing, metrics & profiling across
train/serve/defense (port of ``repro/obs``).

One :class:`Recorder` is threaded through every instrumented path (the
topology plugins, ServeEngine, RobustDecoder, the launch CLIs); it fans
records out to the JSONL format, mirrors scalars into a
Prometheus-exportable metrics registry, and times spans under CUDA's async
launches.  See DESIGN.md §12 for the architecture.
"""
from repro_torch.obs.metrics import (
    DEFAULT_MS_BUCKETS,
    DISABLED,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ObsConfig,
    Recorder,
    as_recorder,
    make_recorder,
)
from repro_torch.obs.schema import ENVELOPE, SCHEMA, check_kind, \
    validate_record
from repro_torch.obs.trace import NULL_SPAN, Span, set_default_recorder, \
    span
from repro_torch.obs.export import parse_exposition, render_prometheus, \
    write_snapshot
from repro_torch.obs.profile import compiled_cost, device_memory_stats, \
    profile_trace

__all__ = [
    "DEFAULT_MS_BUCKETS", "DISABLED", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "ObsConfig", "Recorder", "as_recorder",
    "make_recorder", "ENVELOPE", "SCHEMA", "check_kind", "validate_record",
    "NULL_SPAN", "Span", "set_default_recorder", "span",
    "parse_exposition", "render_prometheus", "write_snapshot",
    "compiled_cost", "device_memory_stats", "profile_trace",
]
