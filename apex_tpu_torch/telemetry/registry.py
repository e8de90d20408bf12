"""Metrics registry: counters / gauges / histograms with rank-0-aware
JSONL emission and host-sync batching.

Counterpart of the JAX package's ``apex_tpu/telemetry/registry.py``, with
its public names, its record :data:`SCHEMA` (equal to the JAX one, so the
JAX ``record_violations`` accepts the port's records) and its semantics:

  * metric updates ACCEPT device tensors and store them unresolved — no
    ``float()``, no ``.item()``, no implicit transfer at the call site;
  * :meth:`Registry.flush` (every ``flush_interval`` steps of the
    :meth:`Registry.step` context) resolves every pending tensor of a
    device with ONE host read: the pending values are stacked on the
    device and copied to the host together (``torch.stack(...).cpu()``,
    where the JAX package calls ``block_until_ready`` and
    ``device_get``); :attr:`Registry.device_reads` counts those reads;
  * disabled mode is a true no-op: updates hit a null metric object,
    nothing is stored, and no device read happens, as between flushes;
  * emission is rank-0 gated (``utils.logging.is_rank0``) and lands as
    JSONL records validated against :data:`SCHEMA`.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from . import export as _export
from . import goodput as _goodput
from . import memory as _memory
from . import trace as _trace

# ---------------------------------------------------------------------------
# record schema (the committed JSONL contract)
# ---------------------------------------------------------------------------

_is_str = lambda v: isinstance(v, str) and bool(v)
_is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
_is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)
_is_dict = lambda v: isinstance(v, dict)

METRIC_TYPES = ("counter", "gauge", "meter", "histogram")

#: Per-kind field predicates.  Each kind maps to (required, optional)
#: field dicts; unknown fields are violations (a reader that would
#: silently ignore them has drifted from the writer).
SCHEMA = {
    "meta": ({"kind": lambda v: v == "meta", "ts": _is_str,
              "fields": _is_dict}, {"run": _is_str}),
    "metric": ({"kind": lambda v: v == "metric", "ts": _is_str,
                "step": _is_int, "name": _is_str,
                "type": lambda v: v in METRIC_TYPES},
               {"value": _is_num, "avg": _is_num, "stats": _is_dict,
                "cum_count": _is_int}),
    "event": ({"kind": lambda v: v == "event", "ts": _is_str,
               "step": _is_int, "name": _is_str, "fields": _is_dict},
              {}),
}

_HIST_STAT_KEYS = frozenset(("count", "sum", "min", "max", "mean"))


def record_violations(rec: Any) -> List[str]:
    """Schema complaints for one JSONL record (empty = valid)."""
    if not isinstance(rec, dict):
        return [f"record is not an object: {rec!r}"]
    kind = rec.get("kind")
    if kind not in SCHEMA:
        return [f"unknown record kind {kind!r}"]
    required, optional = SCHEMA[kind]
    out = []
    for k, pred in required.items():
        if k not in rec:
            out.append(f"{kind}: missing required field {k!r}")
        elif not pred(rec[k]):
            out.append(f"{kind}: bad value for {k!r}: {rec[k]!r}")
    for k, v in rec.items():
        if k in required:
            continue
        if k not in optional:
            out.append(f"{kind}: unknown field {k!r}")
        elif not optional[k](v):
            out.append(f"{kind}: bad value for {k!r}: {v!r}")
    if kind == "metric":
        t = rec.get("type")
        if t == "histogram":
            stats = rec.get("stats")
            if not isinstance(stats, dict):
                out.append("metric: histogram record needs a stats dict")
            else:
                bad = set(stats) ^ _HIST_STAT_KEYS
                if bad:
                    out.append(f"metric: histogram stats keys off-schema: "
                               f"{sorted(bad)}")
                else:
                    out.extend(f"metric: non-numeric stat {k!r}"
                               for k, v in stats.items() if not _is_num(v))
        elif t in ("counter", "gauge", "meter") and not _is_num(
                rec.get("value")):
            out.append(f"metric: {t} record needs a numeric value")
    if kind == "event":
        for k, v in (rec.get("fields") or {}).items():
            if not (_is_num(v) or isinstance(v, (str, bool)) or v is None):
                out.append(f"event: field {k!r} is not a scalar: {v!r}")
    return out


def records_violations(records) -> List[str]:
    """Flatten :func:`record_violations` over a record list."""
    out = []
    for i, rec in enumerate(records):
        out.extend(f"record[{i}]: {v}" for v in record_violations(rec))
    return out


def _ts() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

class JsonlSink:
    """Append-only JSONL file sink.  Validates every record against
    :data:`SCHEMA` before it touches disk (a writer emitting off-schema
    records is a bug — fail the write, not the reader)."""

    def __init__(self, path: str, validate: bool = True):
        self.path = path
        self.validate = validate
        self._fh = None

    def write(self, records) -> None:
        if not records:
            return
        if self.validate:
            bad = records_violations(records)
            if bad:
                raise ValueError("telemetry records fail the committed "
                                 f"schema: {'; '.join(bad[:4])}")
        if self._fh is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
        for rec in records:
            self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class MemorySink:
    """In-memory record list — tests, and benches that embed telemetry
    records into their JSON artifacts (``bench.py`` bert leg)."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, records) -> None:
        self.records.extend(records)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class _NullMetric:
    """The disabled-mode target: every update is a bound no-op — no
    storage, no host sync, nothing to flush.  Mirrors the full update
    AND read surface of every metric class (same defaults), so code
    written against an enabled registry runs unchanged when telemetry
    is switched off."""

    __slots__ = ()

    name = ""
    total = 0.0
    value = None
    val = sum = count = 0.0
    avg = 0.0
    cum_count = 0

    def add(self, v=1, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def update(self, v, n=1):
        pass

    def reset(self):
        pass

    def __str__(self):
        return "<telemetry disabled>"


NULL_METRIC = _NullMetric()


class Counter:
    """Monotonic counter.  ``add`` accepts python numbers or device
    arrays; arrays stay unresolved until the owning registry flushes."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self._pending: list = []

    def add(self, v=1, n=1):
        if n != 1:
            self._pending.append((v, n))
        else:
            self._pending.append(v)

    def _pending_values(self):
        for item in self._pending:
            yield item[0] if isinstance(item, tuple) else item

    def _resolve(self, resolve):
        for item in self._pending:
            if isinstance(item, tuple):
                v, n = item
                self.total += resolve(v) * n
            else:
                self.total += resolve(item)
        self._pending.clear()

    def _record(self, step):
        return {"kind": "metric", "ts": _ts(), "step": step,
                "name": self.name, "type": "counter",
                "value": float(self.total)}


class Gauge:
    """Last-value gauge (loader queue depth, current loss scale, ...)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._pending = None
        self._has_pending = False

    def set(self, v):
        self._pending = v
        self._has_pending = True

    def _pending_values(self):
        if self._has_pending:
            yield self._pending

    def _resolve(self, resolve):
        if self._has_pending:
            self.value = resolve(self._pending)
            self._pending = None
            self._has_pending = False

    def _record(self, step):
        if self.value is None:
            return None
        return {"kind": "metric", "ts": _ts(), "step": step,
                "name": self.name, "type": "gauge",
                "value": float(self.value)}


class Histogram:
    """Windowed distribution: each flush emits count/sum/min/max/mean
    over the observations since the previous flush, plus the cumulative
    count — per-interval step-time stats stay meaningful while the total
    sample count survives for rates."""

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.cum_count = 0
        self._pending: list = []
        self._window: list = []

    def observe(self, v):
        self._pending.append(v)

    def _pending_values(self):
        return iter(self._pending)

    def _resolve(self, resolve):
        for v in self._pending:
            self._window.append(resolve(v))
        self._pending.clear()

    def _record(self, step):
        if not self._window:
            return None
        w = self._window
        self.cum_count += len(w)
        rec = {"kind": "metric", "ts": _ts(), "step": step,
               "name": self.name, "type": "histogram",
               "stats": {"count": len(w), "sum": float(sum(w)),
                         "min": float(min(w)), "max": float(max(w)),
                         "mean": float(sum(w) / len(w))},
               "cum_count": self.cum_count}
        self._window = []
        return rec


class AverageMeter:
    """Running value/average (the reference ``AverageMeter``,
    ``examples/imagenet/main_amp.py:363``).  Standalone it behaves
    exactly like the old ``utils.logging`` copy; constructed through
    :meth:`Registry.meter` it also emits a ``meter`` record (value +
    running avg) on every registry flush — the "meters move behind the
    registry" step of the telemetry redesign."""

    kind = "meter"

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"

    # registry protocol (meters resolve eagerly: update() already takes
    # a float — the caller opted into the sync, as the reference notes)
    def _pending_values(self):
        return iter(())

    def _resolve(self, resolve):
        pass

    def _record(self, step):
        if not self.count:
            return None
        return {"kind": "metric", "ts": _ts(), "step": step,
                "name": self.name, "type": "meter",
                "value": float(self.val), "avg": float(self.avg)}


class Throughput:
    """items/sec between ``tick()`` calls — the Speed print helper.  The
    host sync needed for honest timing is the CALLER's float() readback
    (the reference's 'printing costs a sync' note applies unchanged)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.meter = AverageMeter("items/s")

    def tick(self, n_items: int) -> float:
        now = time.perf_counter()
        rate = n_items / max(now - self.t0, 1e-9)
        self.meter.update(rate)
        self.t0 = now
        return rate


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _to_host(flat: torch.Tensor) -> List[float]:
    """The one device-to-host copy of a flush: ``flat`` (float64 on a
    device) as host floats."""
    return flat.cpu().tolist()


def _env_enabled() -> bool:
    return _trace.env_flag("APEX_TPU_TELEMETRY")


class Registry:
    """Host-side metric registry wrapped around a train step.

    Usage::

        reg = telemetry.Registry(sink=telemetry.JsonlSink("run.jsonl"),
                                 flush_interval=10)
        for batch in loader:
            with reg.step():
                state, loss = train_step(state, batch)   # async on the card
                reg.gauge("loss").set(loss)              # stays on device
                reg.counter("examples").add(batch_size)
        reg.flush()

    ``loss`` above is a device tensor: nothing syncs until the flush
    interval is reached, then ONE host read a device resolves every
    pending value (:attr:`device_reads` counts them).
    ``flush_interval=0`` means manual flushing only.

    ``enabled=False`` (or ``APEX_TPU_TELEMETRY=0``) turns every metric
    accessor into :data:`NULL_METRIC` and :meth:`step` into a bare
    yield — a true no-op with zero host syncs and no sink writes.
    """

    def __init__(self, *, sink=None, enabled: Optional[bool] = None,
                 flush_interval: int = 1, rank0_only: bool = True,
                 run_id: Optional[str] = None, memory=None, goodput=None,
                 exporter=None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.sink = sink
        # live OpenMetrics export (docs/telemetry.md Fleet view + live
        # export): ``exporter`` pins a telemetry.export.MetricsExporter,
        # None consults the process-installed one at each flush (the
        # guard arms it when APEX_TPU_METRICS_PORT is set), False
        # switches the snapshot off.  The snapshot copies the flush's
        # already-resolved records — no sync, and with no exporter
        # installed the cost is one module-default check per flush.
        self._exporter = exporter
        # run-level goodput gauges (docs/telemetry.md Goodput ledger):
        # ``goodput`` pins a telemetry.goodput.GoodputLedger, None
        # consults the process-installed ledger at each flush (the
        # guard installs its run ledger there), False switches the
        # export off.  The ledger's gauges are plain host floats — they
        # resolve inside the flush's one batched read, adding no sync.
        self._goodput = goodput
        # live-memory gauges (docs/telemetry.md Memory): ``memory`` is a
        # telemetry.memory.MemoryMonitor, None for the env-gated default
        # (APEX_TPU_TELEMETRY_MEM), or False to switch polling off.  A
        # disabled/absent monitor costs one attribute check per flush;
        # a backend without allocator stats costs one probe, ever.
        if not self.enabled or memory is False:
            self._memory = None
        else:
            mon = memory if memory is not None else _memory.MemoryMonitor()
            self._memory = mon if mon.enabled else None
        self.flush_interval = int(flush_interval)
        self.rank0_only = rank0_only
        self.run_id = run_id
        self._metrics: Dict[str, Any] = {}
        # guards metric CREATION only: the guard's background ckpt
        # writer may mint its gauges while the main thread flushes
        # (updates stay lock-free — appends/assignments are atomic)
        self._metrics_lock = threading.Lock()
        self._events: List[dict] = []
        self._step = 0
        self._wrote_meta = False
        #: host reads of device tensors made by flushes (one a device a
        #: flush with pending device values; none otherwise)
        self.device_reads = 0

    # -- metric accessors ---------------------------------------------------
    def _get(self, name: str, cls):
        if not self.enabled:
            return NULL_METRIC
        m = self._metrics.get(name)
        if m is None:
            with self._metrics_lock:
                m = self._metrics.get(name)      # lost the race?
                if m is None:
                    m = self._metrics[name] = cls(name)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def meter(self, name: str) -> AverageMeter:
        return self._get(name, AverageMeter)

    # -- events -------------------------------------------------------------
    def event(self, name: str, **fields) -> None:
        """Buffer a structured event (written at the next flush).  Field
        values must be scalars/strings; device tensors are resolved at
        flush with the batched read.

        Lifecycle namespaces riding this channel: the guard's
        resilience events (``fault_injected`` / ``rollback`` /
        ``resumed`` / ``preempted``), elastic's ``elastic.*``, and the
        run controller's ``control.*`` decisions (``control.decision``
        / ``control.suppressed`` / ``control.action_failed`` — every
        one also a row in ``CONTROL.json``), which
        ``report.summarize`` folds into the summary's control line."""
        if not self.enabled:
            return
        self._events.append({"kind": "event", "ts": _ts(),
                             "step": self._step, "name": name,
                             "fields": fields})
        # real-time copy into the flight-recorder ring (one attribute
        # check when no tracer is installed): a crash dump must hold
        # the events from BEFORE the flush that never happened
        _trace.note_event(name, step=self._step, fields=fields)

    # -- the step context ---------------------------------------------------
    @contextlib.contextmanager
    def step(self):
        """Time one training step and auto-flush every
        ``flush_interval`` steps.  Disabled mode: a bare yield — no
        timing, no counters, no syncs."""
        if not self.enabled:
            yield self
            return
        self._step += 1
        t0 = time.perf_counter()
        yield self
        dt = time.perf_counter() - t0
        self.histogram("step_time_ms").observe(dt * 1e3)
        # span + slow-step sentinel through the default tracer (one
        # attribute check when none is installed); THIS registry rides
        # along so a sentinel fire is recorded in this run's stream
        _trace.note_step(self._step, dt, registry=self)
        if self.flush_interval and self._step % self.flush_interval == 0:
            self.flush()

    @property
    def current_step(self) -> int:
        return self._step

    # -- flush --------------------------------------------------------------
    def _resolver(self):
        """One batched host read a device for every pending tensor
        value (one-element tensors); python and numpy numbers pass
        through untouched.  The pending tensors of a device are stacked
        there (one stack a dtype, widened to float64 and joined) and
        copied to the host together: this is the registry's single sync
        point, never inside the step."""
        tensors = []
        # list(): atomic snapshot — a background thread (a checkpoint
        # writer) may mint a new metric mid-iteration
        for m in list(self._metrics.values()):
            for v in m._pending_values():
                if isinstance(v, torch.Tensor):
                    tensors.append(v)
        for ev in self._events:
            for v in ev["fields"].values():
                if isinstance(v, torch.Tensor):
                    tensors.append(v)
        resolved: Dict[int, float] = {}
        by_device: Dict[Any, Dict[Any, list]] = {}
        for t in tensors:
            by_device.setdefault(t.device, {}).setdefault(
                t.dtype, []).append(t)
        for device, groups in by_device.items():
            order = [t for ts in groups.values() for t in ts]
            flat = torch.cat([
                torch.stack([t.detach().reshape(()) for t in ts]).to(
                    torch.float64) for ts in groups.values()])
            if device.type == "cpu":
                values = flat.tolist()
            else:
                values = _to_host(flat)
                self.device_reads += 1
            for t, host in zip(order, values):
                resolved[id(t)] = float(host)

        def resolve(v):
            if isinstance(v, torch.Tensor):
                return resolved.get(id(v), 0.0)
            return float(v)

        return resolve

    def _emit_allowed(self) -> bool:
        if not self.rank0_only:
            return True
        from ..utils.logging import is_rank0
        return is_rank0()

    def flush(self) -> List[dict]:
        """Resolve pending values (one batched read), build records, and
        write them to the sink (rank-0 gated).  Returns the records so
        in-process consumers (benches) can embed them."""
        if not self.enabled:
            return []
        if self._memory is not None:
            # part of the flush's batched host window: one allocator
            # read -> mem.* gauges (resolved just below, they are
            # plain floats) + the tracer's device_mem counter track
            self._memory.observe_flush(self)
        if self._goodput is not False:
            led = (self._goodput if self._goodput is not None
                   else _goodput.get_ledger())
            if led is not None and led.enabled:
                # refresh goodput.fraction / badput.* gauges inside the
                # same batched window (plain floats, zero extra sync)
                led.observe_flush(self)
        resolve = self._resolver()
        records: List[dict] = []
        if not self._wrote_meta:
            self._wrote_meta = True
            meta = {"kind": "meta", "ts": _ts(),
                    "fields": {"schema": 1}}
            if self.run_id:
                meta["run"] = self.run_id
            records.append(meta)
        for m in list(self._metrics.values()):
            m._resolve(resolve)
            rec = m._record(self._step)
            if rec is not None:
                records.append(rec)
        for ev in self._events:
            ev["fields"] = {k: (resolve(v) if isinstance(v, torch.Tensor)
                                else v)
                            for k, v in ev["fields"].items()}
            records.append(ev)
        self._events = []
        if records and self._exporter is not False:
            exp = (self._exporter if self._exporter is not None
                   else _export.get_exporter())
            if exp is not None:
                # the live scrape snapshot: the SAME resolved records
                # this flush just built, copied under the exporter's
                # lock — inside the batched window, zero extra syncs
                exp.observe_flush(self, records)
        if records:
            _trace.note_flush(self._step, records)
        if self.sink is not None and records and self._emit_allowed():
            self.sink.write(records)
        return records

    def close(self) -> None:
        self.flush()
        if self.sink is not None:
            self.sink.close()

    # -- introspection ------------------------------------------------------
    def read(self) -> Dict[str, Any]:
        """Current aggregate per metric (resolves pending values)."""
        if not self.enabled:
            return {}
        resolve = self._resolver()
        out = {}
        for name, m in list(self._metrics.items()):
            m._resolve(resolve)
            if isinstance(m, Counter):
                out[name] = m.total
            elif isinstance(m, Gauge):
                out[name] = m.value
            elif isinstance(m, AverageMeter):
                out[name] = m.avg
            elif isinstance(m, Histogram):
                out[name] = {"window": list(m._window),
                             "cum_count": m.cum_count}
        return out
