"""apex_tpu_torch.telemetry: the port's training and serving telemetry.

Counterpart of the JAX package's ``apex_tpu.telemetry``; every record,
document and artifact keeps the JAX schema, so the JAX validators accept
the port's output.  Host-side throughout: the registry reads the device
once a flush, and :func:`events.observe_scaler` (so :func:`observe_amp`)
once a call, a sync of its own outside the registry's count; nothing else
here reads a device tensor.

  * :mod:`registry` -- counters / gauges / histograms / meters behind a
    ``step()`` context, one device read a flush, rank-0-gated JSONL
    validated against :data:`SCHEMA`, a no-op disabled mode;
  * :mod:`events` -- amp scaler transitions, loader / shard / checkpoint
    / collective hooks through a process-default registry;
  * :mod:`trace` -- host span tracer (Chrome export), the flight
    recorder, the slow-step sentinel (one-shot ``torch.profiler``
    capture);
  * :mod:`attrib` -- per-op FLOPs / bytes attribution of one recorded
    call (dispatched aten ops and hand-kernel launches), with
    blas / conv / pointwise / reduction / collective / memory / other
    rollups;
  * :mod:`memory` -- peak-memory attribution from a liveness sweep over
    one recorded call (``memory_table`` / ``memory_model``), live
    allocator gauges and the OOM post-mortem;
  * :mod:`timeline` -- per-device, per-step decomposition of a
    ``torch.profiler`` capture: compute vs collective vs EXPOSED
    collective ms (exact interval subtraction), idle time, straggler
    z-scores, a correlated host + device Chrome merge;
  * :mod:`goodput` -- the run's wall-clock partition and
    ``GOODPUT.json``;
  * :mod:`fleet` -- N per-host run dirs merged into one ``FLEET.json``;
  * :mod:`export` -- the live OpenMetrics endpoint;
  * :mod:`serve_ledger` -- the per-request serving ledger and
    ``SERVE.json``;
  * :mod:`report` -- JSONL summary and the ``python -m
    apex_tpu_torch.telemetry`` CLI.
"""
from . import trace
from . import registry
from . import events
from . import memory
from . import timeline
from . import goodput
from . import fleet
from . import export
from .registry import (SCHEMA, Registry, Counter, Gauge, Histogram,
                       AverageMeter, Throughput, JsonlSink, MemorySink,
                       NULL_METRIC, record_violations, records_violations)
from .events import (set_default, get_default, active, observe_scaler,
                     observe_amp, record_collective, record_loader,
                     record_ckpt)
from .trace import (Tracer, FlightRecorder, SlowStepSentinel, NULL_SPAN,
                    set_tracer, get_tracer, span, traced)
from .memory import (MemoryMonitor, memory_table, memory_model,
                     format_memory_table)
from .goodput import GoodputLedger, goodput_violations, FAULT_BADPUT
from .fleet import build_fleet, fleet_violations
from .export import MetricsExporter

__all__ = [
    "trace", "registry", "events", "memory", "timeline", "goodput",
    "fleet", "export",
    "SCHEMA",
    "Registry",
    "Counter", "Gauge",
    "Histogram", "AverageMeter", "Throughput", "JsonlSink", "MemorySink",
    "NULL_METRIC", "record_violations", "records_violations",
    "set_default", "get_default", "active", "observe_scaler",
    "observe_amp", "record_collective", "record_loader", "record_ckpt",
    "Tracer", "FlightRecorder", "SlowStepSentinel", "NULL_SPAN",
    "set_tracer", "get_tracer", "span", "traced",
    "MemoryMonitor", "memory_table", "memory_model",
    "format_memory_table",
    "GoodputLedger", "goodput_violations", "FAULT_BADPUT",
    "build_fleet", "fleet_violations", "MetricsExporter",
]
