"""repro_torch.obs — the Recorder bus, metrics registry and span tracer that
the serving engine and the ``serve`` topology thread (port of the parts of
``repro/obs`` they call; the exposition, report and profile modules come with
ROADMAP queue 1 item 14).  See DESIGN.md §12 for the architecture.
"""
from repro_torch.obs.metrics import (  # noqa: F401
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
from repro_torch.obs.schema import SCHEMA, check_kind  # noqa: F401
from repro_torch.obs.trace import NULL_SPAN, Span  # noqa: F401
