"""Runtime telemetry: structured spans, counters, and trace export.

The observability layer for the execution stack — one :class:`Tracer`
threads through the engines (`repro_torch.fl.engine`), the
scheduler/prefetcher (`repro_torch.channels.scheduler`) and the schedule
(`repro_torch.channels.schedule`), recording nested spans, instants and
monotonic counters into a bounded in-memory buffer.  Exporters turn a run
into a Perfetto-loadable Chrome trace (host/device overlap visible as
parallel tracks) or a JSONL stream; ``python -m repro_torch.obs.summary`` prints
the per-phase time attribution table.  Disabled tracing is the
:data:`NULL_TRACER` singleton — a single-attribute-check no-op, so
untraced runs stay bit- and perf-identical.

The PyTorch counterpart of the JAX package's ``obs``, kept line for line:
the trace formats are the same, so either package's summary CLI reads
either package's trace files.  ``docs/observability.md`` describes the span
model and the track/category conventions.
"""
from repro_torch.obs.export import (
    chrome_trace,
    load_trace_file,
    phase_attribution,
    phase_attribution_loaded,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    InstantEvent,
    NullTracer,
    SpanEvent,
    Tracer,
)

__all__ = [
    "InstantEvent",
    "NULL_TRACER",
    "NullTracer",
    "SpanEvent",
    "Tracer",
    "chrome_trace",
    "load_trace_file",
    "phase_attribution",
    "phase_attribution_loaded",
    "write_chrome_trace",
    "write_jsonl",
]
