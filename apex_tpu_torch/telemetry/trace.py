"""Host-side span tracing, the flight recorder, and the slow-step sentinel.

Counterpart of the JAX package's ``apex_tpu/telemetry/trace.py``, with
the same public names, record shapes and dump schema (the JAX
``dump_violations`` accepts the port's flight dumps, and the JAX
``load_chrome`` reads the port's Chrome files).  Three pieces:

  * :class:`Tracer` -- a thread-safe host span tracer.
    ``span("ckpt.write")`` works as a context manager and (via
    :func:`traced`) a decorator; timestamps come from the monotonic
    ``time.perf_counter_ns`` clock; completed spans export as
    Chrome-trace/Perfetto JSON (``ph: "X"`` complete events).  Disabled
    mode is a no-op: ``span()`` returns the shared :data:`NULL_SPAN`
    singleton, with no device read and no allocation.
  * :class:`FlightRecorder` -- a bounded ring of the last N
    spans/events/metric flushes.  ``dump(reason)`` writes a timestamped,
    schema-validated JSON file (``flight-<reason>-<ts>.json``), so a
    crash or rollback leaves a record of what ran just before it.
  * :class:`SlowStepSentinel` -- a rolling step-time baseline.  A z-score
    breach (a step suddenly 3x slower) dumps the flight recorder and can
    open a one-shot ``torch.profiler`` capture over the next few steps,
    written as a Chrome trace under ``profile_dir``.

Divergence from the JAX module: the capture is ``torch.profiler`` where
the JAX package opens ``jax.profiler``.  As there, a finished capture is
decomposed into a per-step device table (:mod:`.timeline`) and dumped as
a ``slow_step_timeline`` flight document, and :func:`load_chrome` reads
Chrome JSON (plain, gzip, or a streaming array) and profiler directories
through ``pyprof.parse``.

Divergence from the JAX module: while a ``torch.profiler`` session
records, every span (:func:`span`, :func:`traced`, :meth:`Tracer.span`)
also opens a ``torch.profiler.record_function`` range of its name,
whether or not a tracer is installed (:func:`profiler_range`).  The range
lands in the profiler's trace on its clock, and Kineto mirrors it onto
the streams its launches went to as ``gpu_user_annotation``, so a span
names device work without a second clock.  The JAX package's spans never
reach its profiler.  :data:`STEP_SPANS` names the spans inside the
training step.

Nothing here touches the device.  Library hooks route through the
process-default tracer (:func:`set_tracer`); with none installed and no
profiler recording, every hook is two attribute checks and :func:`span`
returns :data:`NULL_SPAN`.
"""
from __future__ import annotations

import collections
import functools
import gzip
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

from torch.autograd import profiler as _profiler

__all__ = [
    "Tracer", "FlightRecorder", "SlowStepSentinel", "NULL_SPAN",
    "STEP_SPANS", "set_tracer", "get_tracer", "active", "span", "traced",
    "profiler_range",
    "note_span", "note_event", "note_flush", "note_step", "note_counter",
    "load_chrome", "span_summary", "format_span_summary",
    "dump_violations", "cli",
]


def _clean(v):
    """Ring/dump field values must serialize: scalars pass; anything
    array-shaped becomes a shape/dtype TAG — ``repr`` on a device array
    materializes the value (a blocking host sync), which this subsystem
    exists to avoid, so the ring stores the metadata and the resolved
    value stays the flushed JSONL's job; everything else degrades to a
    short repr."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "dtype"):
        return (f"<{type(v).__name__}{tuple(getattr(v, 'shape', ()))} "
                f"{v.dtype}>")
    return repr(v)[:80]


def _clean_fields(fields: Optional[dict]) -> dict:
    if not fields:
        return {}
    return {str(k): _clean(v) for k, v in fields.items()}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """The disabled-mode span: a shared singleton whose enter/exit do
    nothing and whose decorator form returns the function unchanged —
    the zero-overhead contract (no allocation, no clock read)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


NULL_SPAN = _NullSpan()


#: The spans inside the training step (``train.train_step`` and what it
#: calls), each opened where its work happens.  ``train.forward`` holds
#: the ``model.*`` spans and ``amp.step`` the other ``amp.*``; the
#: ``attention.*`` spans nest in ``model.attention``.
STEP_SPANS = (
    "train.forward", "train.backward",
    "model.embed", "model.attention", "attention.qkv", "attention.core",
    "attention.out", "model.mlp", "model.head", "model.loss",
    "amp.step", "amp.unscale", "amp.flatten", "amp.optimizer",
    "amp.select", "amp.model_copy",
)


class _Span:
    """One live span handle (context manager + decorator): the tracer's
    ``perf_counter_ns`` interval where ``tracer`` is given, and a
    ``record_function`` range of ``name`` where a profiler session is
    recording when it opens.  Handles nest LIFO within a thread; for
    concurrent threads create one handle per thread
    (``tracer.span(...)`` per ``with`` statement -- the normal usage --
    does exactly that)."""

    __slots__ = ("_tracer", "name", "attrs", "_open")

    def __init__(self, tracer: Optional["Tracer"], name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._open: List[tuple] = []

    def __enter__(self):
        rng = None
        if _profiler._is_profiler_enabled:
            rng = _profiler.record_function(self.name)
            rng.__enter__()
        self._open.append((time.perf_counter_ns(), rng))
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        t0, rng = self._open.pop() if self._open else (t1, None)
        if rng is not None:
            rng.__exit__(*exc)
        if self._tracer is not None:
            self._tracer._record(self.name, t0, t1 - t0, self.attrs)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            handle = (profiler_range(self.name) if self._tracer is None
                      else self._tracer.span(self.name, **self.attrs))
            with handle:
                return fn(*args, **kwargs)
        return wrapped


def profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler session records, else :data:`NULL_SPAN`.  The check is one
    read of the flag ``torch.autograd.profiler`` sets on entering a
    session (measured cheaper than asking the profiler's C++ state), so
    with no session nothing is allocated and no ``RecordFunction`` made.
    The one range mechanism of the port: every span, and
    :func:`~apex_tpu_torch.pyprof.annotate`, goes through it."""
    if not _profiler._is_profiler_enabled:
        return NULL_SPAN
    return _Span(None, name, {})


def env_flag(name: str, default: bool = True) -> bool:
    """Shared boolean-env vocabulary for the telemetry/resilience
    enable switches (``APEX_TPU_TRACE`` / ``APEX_TPU_TELEMETRY`` /
    ``APEX_TPU_GUARD``, the JAX package's names): 0/off/false/no
    disable -- one parser, so the subsystems cannot drift."""
    return os.environ.get(name, "1" if default else "0").lower() not in (
        "0", "off", "false", "no")


def _env_enabled() -> bool:
    return env_flag("APEX_TPU_TRACE")


class FlightRecorder:
    """Bounded ring of the most recent trace entries (spans, events,
    metric flushes, instants).  ``dump()`` writes the ring as one
    timestamped JSON document so a crash/rollback leaves a black-box
    record of the seconds before it."""

    def __init__(self, capacity: int = 512, directory: Optional[str] = None):
        self.capacity = int(capacity)
        self.directory = directory
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total = 0          # entries ever recorded (incl. evicted)
        self.dumps = 0

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)
            self.total += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, reason: str, *, step: Optional[int] = None,
             directory: Optional[str] = None, path: Optional[str] = None,
             fields: Optional[dict] = None,
             sections: Optional[dict] = None) -> Optional[str]:
        """Write the ring to ``path`` (or a timestamped
        ``flight-<reason>-<ts>.json`` under ``directory`` /
        ``self.directory``).  Returns the written path, or None when no
        destination is configured — a recorder without a home must not
        litter the cwd.  ``sections`` adds whole top-level documents to
        the dump (the OOM post-mortem's ``oom`` section) — callers own
        their section's schema; the core keys cannot be clobbered."""
        entries = self.snapshot()
        doc = {
            "kind": "flight_recorder",
            "version": 1,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "reason": str(reason),
            "step": None if step is None else int(step),
            "fields": _clean_fields(fields),
            "capacity": self.capacity,
            "n_entries": len(entries),
            "total_recorded": self.total,
            "entries": entries,
        }
        for key, value in (sections or {}).items():
            if key not in doc:
                doc[key] = value
        if path is None:
            d = directory or self.directory
            if d is None:
                return None
            os.makedirs(d, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            path = os.path.join(
                d, f"flight-{reason}-{stamp}-{os.getpid()}"
                   f"-{self.dumps}.json")
        bad = dump_violations(doc)
        if bad:   # writer-validates, the JsonlSink posture
            raise ValueError("flight-recorder dump fails its schema: "
                             + "; ".join(bad[:4]))
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        self.dumps += 1
        return path


ENTRY_KINDS = ("span", "instant", "event", "metric_flush", "counter")

_is_str = lambda v: isinstance(v, str)
_is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
_is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)


def dump_violations(doc: Any) -> List[str]:
    """Schema complaints for a flight-recorder dump (empty = valid)."""
    if not isinstance(doc, dict):
        return [f"dump is not an object: {type(doc).__name__}"]
    out = []
    if doc.get("kind") != "flight_recorder":
        out.append(f"bad kind {doc.get('kind')!r}")
    if doc.get("version") != 1:
        out.append(f"unknown version {doc.get('version')!r}")
    for key, pred in (("ts", _is_str), ("reason", _is_str),
                      ("capacity", _is_int), ("n_entries", _is_int)):
        if not pred(doc.get(key)):
            out.append(f"bad/missing {key!r}: {doc.get(key)!r}")
    if doc.get("step") is not None and not _is_int(doc.get("step")):
        out.append(f"bad step {doc.get('step')!r}")
    if not isinstance(doc.get("fields"), dict):
        out.append("fields must be a dict")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return out + ["entries must be a list"]
    if _is_int(doc.get("n_entries")) and doc["n_entries"] != len(entries):
        out.append(f"n_entries={doc['n_entries']} but "
                   f"{len(entries)} entries present")
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            out.append(f"entry[{i}] is not an object")
            continue
        k = e.get("kind")
        if k not in ENTRY_KINDS:
            out.append(f"entry[{i}]: unknown kind {k!r}")
            continue
        if not _is_str(e.get("name")):
            out.append(f"entry[{i}]: bad name {e.get('name')!r}")
        if k == "span" and not (_is_num(e.get("t_us"))
                                and _is_num(e.get("dur_us"))):
            out.append(f"entry[{i}]: span needs numeric t_us/dur_us")
        if k == "metric_flush" and not _is_int(e.get("n_records")):
            out.append(f"entry[{i}]: metric_flush needs n_records")
        if k == "counter":
            vals = e.get("values")
            if not (isinstance(vals, dict)
                    and all(_is_num(v) for v in vals.values())):
                out.append(f"entry[{i}]: counter needs a numeric "
                           f"values dict")
    return out


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------

class SlowStepSentinel:
    """Rolling step-time baseline with z-score anomaly detection.

    ``observe(step, seconds)`` keeps the last ``window`` step times;
    once ``warmup`` samples exist, a step whose z-score exceeds
    ``z_threshold`` AND is at least ``min_slowdown``x the rolling mean
    fires: the flight recorder is dumped (``reason="slow_step"``), a
    ``sentinel.slow_step`` event goes to the default registry, and —
    when ``profile_dir`` is set — a ONE-SHOT ``torch.profiler`` trace
    opens for the next ``profile_steps`` observed steps (at most
    ``max_captures`` windows per process, so an unlucky baseline can't
    fill a disk with traces).  Breaching samples are NOT added to the
    baseline (an anomaly must not normalize itself); ``cooldown``
    steps must pass between fires, and ``max_fires`` bounds the total
    — at the cap the sentinel ADOPTS the new regime (samples absorb
    into the baseline again), so a permanent legitimate slowdown can't
    fill a directory with one dump per cooldown for the rest of the
    run.  Dumps land in ``dump_dir``, else the tracer's
    ``flight_dir``, else ``profile_dir`` — with none of the three set
    the dump is skipped (the fire info's ``dump`` field says so) and
    only the event/instant land.
    """

    def __init__(self, *, window: int = 64, warmup: int = 16,
                 z_threshold: float = 4.0, min_slowdown: float = 1.5,
                 cooldown: int = 50, max_fires: int = 10,
                 dump_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 profile_steps: int = 3, max_captures: int = 1):
        if warmup < 2:
            raise ValueError("warmup must be >= 2 (a std needs samples)")
        if warmup > window:
            raise ValueError(
                f"warmup ({warmup}) > window ({window}) would disarm the "
                "sentinel forever: the ring caps at window samples, so "
                "the warmup gate could never pass")
        self.window = collections.deque(maxlen=int(window))
        self.warmup = int(warmup)
        self.z_threshold = float(z_threshold)
        self.min_slowdown = float(min_slowdown)
        self.cooldown = int(cooldown)
        self.max_fires = int(max_fires)
        self.dump_dir = dump_dir
        self.profile_dir = profile_dir
        self.profile_steps = int(profile_steps)
        self.max_captures = int(max_captures)
        self.fires = 0
        self.captures = 0
        self._cooldown_left = 0
        self._capture_steps_left = 0
        self._capturing = False
        self._capture_tracer: Optional["Tracer"] = None
        self._profiler = None
        #: the Chrome trace of each finished capture
        self.capture_paths: List[str] = []

    def _stats(self):
        n = len(self.window)
        mean = sum(self.window) / n
        var = sum((v - mean) ** 2 for v in self.window) / n
        return mean, math.sqrt(var)

    # -- profiler capture (the one-shot window) -----------------------------
    def _start_capture(self, tracer: Optional["Tracer"] = None) -> bool:
        if (self.profile_dir is None or self._capturing
                or self.captures >= self.max_captures):
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception:      # profiler unavailable: the dump still lands
            return False
        self._profiler = prof
        self._capturing = True
        self._capture_tracer = tracer
        self._capture_steps_left = self.profile_steps
        self.captures += 1
        # a run that crashes or ends INSIDE the window (exactly when an
        # anomaly capture matters most) would otherwise never call
        # stop_trace and the profiler would flush nothing — close the
        # window at interpreter exit as the backstop
        import atexit
        atexit.register(self.stop_capture)
        return True

    def stop_capture(self) -> None:
        """Close an open profiler window now (idempotent) — called at
        the end of the profile_steps window, and registered as an
        atexit backstop so a crash mid-window still flushes the
        capture, which lands as a Chrome trace
        (``slow-step-<pid>-<n>.pt.trace.json``) under ``profile_dir``
        (its path appended to :attr:`capture_paths`)."""
        if not self._capturing:
            return
        self._capturing = False
        prof, self._profiler = self._profiler, None
        try:
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(
                self.profile_dir,
                f"slow-step-{os.getpid()}-{self.captures}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.capture_paths.append(path)
        except Exception:
            return          # nothing flushed: nothing to decompose
        self._attach_timeline()

    def _attach_timeline(self) -> None:
        """Best-effort: decompose the just-written capture
        (:func:`.timeline.summarize`) and dump the per-step device table
        as a ``slow_step_timeline`` flight document with a ``timeline``
        section -- the slow-step dump names WHEN it happened, this one
        WHERE the device time went.  A goodput ledger on the capture's
        tracer takes the decomposition, so its exposed-comm carve is the
        measured one.  Any failure (no device lanes, a full disk) is
        swallowed: observability must never kill the train loop."""
        tr = self._capture_tracer
        self._capture_tracer = None
        if tr is None or not self.capture_paths:
            return
        try:
            from . import timeline as _timeline
            decomp = _timeline.summarize(self.capture_paths[-1])
            if not decomp["devices"]:
                return
            led = getattr(tr, "ledger", None)
            if led is not None:
                led.set_decomposition(decomp)
            tr.recorder.dump(
                "slow_step_timeline",
                directory=(self.dump_dir or tr.recorder.directory
                           or self.profile_dir),
                fields={"profile_dir": self.profile_dir,
                        "n_devices": len(decomp["devices"]),
                        "exposed_comm_ms":
                            decomp["totals"]["exposed_comm_ms"]},
                sections={"timeline": {
                    "decomposition": decomp,
                    "table": _timeline.format_decomposition(decomp)}})
        except Exception:
            pass

    def _maybe_stop_capture(self) -> None:
        if not self._capturing:
            return
        self._capture_steps_left -= 1
        if self._capture_steps_left > 0:
            return
        self.stop_capture()

    def observe(self, step: int, seconds: float,
                tracer: Optional["Tracer"] = None,
                registry=None) -> Optional[dict]:
        """Feed one step time.  Returns the fire-info dict when the
        sentinel tripped, else None.  ``registry`` pins where the
        ``sentinel.slow_step`` event lands — ``Registry.step()`` passes
        ITSELF, so a run on a non-default registry still records the
        fire in its own JSONL; default: the process default."""
        self._maybe_stop_capture()
        in_cooldown = self._cooldown_left > 0
        if in_cooldown:
            self._cooldown_left -= 1
        if len(self.window) < self.warmup:
            self.window.append(seconds)
            return None
        mean, std = self._stats()
        z = (seconds - mean) / max(std, 1e-9)
        if z < self.z_threshold or seconds < mean * self.min_slowdown:
            self.window.append(seconds)
            return None
        # breach: do NOT absorb the outlier into the baseline — cooldown
        # suppresses only the FIRE, or a sustained regression would
        # normalize itself during its own cooldown and never fire again
        if self.fires >= self.max_fires:
            # fire budget spent: adopt the new regime so a permanent
            # legitimate slowdown stops breaching instead of dumping
            # once per cooldown forever
            self.window.append(seconds)
            return None
        if in_cooldown:
            return None
        self.fires += 1
        self._cooldown_left = self.cooldown
        tr = tracer if tracer is not None else get_tracer()
        info = {"step": int(step), "step_seconds": float(seconds),
                "baseline_mean_s": float(mean), "baseline_std_s": float(std),
                "z": float(z), "profile_started": self._start_capture(tr)}
        dump_path = None
        if tr is not None:
            tr.instant("sentinel.slow_step", **info)
            directory = (self.dump_dir or tr.recorder.directory
                         or self.profile_dir)
            try:
                dump_path = tr.recorder.dump("slow_step", step=step,
                                             directory=directory,
                                             fields=info)
            except Exception:  # a full disk (or an off-schema ring
                dump_path = None   # entry) must not kill the train loop
        info["dump"] = dump_path
        if registry is None:
            from . import events as _events
            registry = _events.get_default()
        if registry is not None and registry.enabled:
            registry.event("sentinel.slow_step", **info)
        return info


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Thread-safe host span tracer + flight recorder owner.

    Usage::

        tracer = trace.Tracer(flight_dir="flight/")
        trace.set_tracer(tracer)                 # library hooks report in
        with trace.span("ckpt.write", step=i):   # or tracer.span(...)
            ...
        tracer.write("run.trace.json")           # chrome://tracing / Perfetto

    ``ring`` bounds the flight recorder; ``max_spans`` bounds the full
    export buffer (oldest spans drop first — the ring still holds the
    newest, and ``dropped_spans`` counts the loss so a truncated export
    can't read as a complete one).  ``enabled=None`` reads
    ``APEX_TPU_TRACE`` (default on).  Disabled: ``span()`` returns
    :data:`NULL_SPAN` and every note is a no-op.
    """

    def __init__(self, *, enabled: Optional[bool] = None, ring: int = 512,
                 max_spans: int = 100_000, flight_dir: Optional[str] = None,
                 sentinel: Optional[SlowStepSentinel] = None,
                 process_name: str = "apex_tpu_torch"):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.recorder = FlightRecorder(ring, directory=flight_dir)
        self.sentinel = sentinel
        # run-level goodput ledger hook (telemetry.goodput): when a
        # GoodputLedger is attached, every completed span/event streams
        # into its wall-clock accounting LIVE — no dependence on the
        # bounded flight ring, so a long run's ledger never loses its
        # early intervals.  One attribute check when detached.
        self.ledger = None
        self.max_spans = int(max_spans)
        self.process_name = process_name
        self.dropped_spans = 0
        # chrome-shaped, lock-protected; deque so eviction at max_spans
        # is O(1) — a list.pop(0) would make every span O(max_spans)
        # under the lock once the buffer fills (hot-path quadratic)
        self._events: "collections.deque" = collections.deque(
            maxlen=self.max_spans)
        self._threads: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs):
        """A context manager timing one span (also usable as a
        decorator), mirrored into a recording profiler session.
        Disabled tracer: :func:`profiler_range` alone (the shared no-op
        singleton with no session)."""
        if not self.enabled:
            return profiler_range(name)
        return _Span(self, name, attrs)

    def add(self, name: str, dur_s: float, *, t0_ns: Optional[int] = None,
            **attrs) -> None:
        """Record an already-measured span ending now (the post-hoc
        form for code that timed itself, e.g. the loader's wait)."""
        if not self.enabled:
            return
        t1 = time.perf_counter_ns()
        dur_ns = max(int(dur_s * 1e9), 0)
        self._record(name, t1 - dur_ns if t0_ns is None else t0_ns,
                     dur_ns, attrs)

    def counter(self, name: str, step: Optional[int] = None,
                **values) -> None:
        """Record a Chrome counter sample (``ph: "C"``) — Perfetto
        renders one numeric track per ``values`` key under the span
        rows (the live-memory curve).  Non-numeric values are dropped
        rather than corrupting the track."""
        if not self.enabled:
            return
        vals = {str(k): float(v) for k, v in values.items()
                if isinstance(v, (int, float))
                and not isinstance(v, bool)}
        if not vals:
            return
        ev = {"ph": "C", "name": name,
              "ts": time.perf_counter_ns() / 1e3,
              "pid": self._pid, "args": vals}
        with self._lock:
            self._append(ev)
        rec = {"kind": "counter", "name": name, "values": vals}
        if step is not None:
            rec["step"] = int(step)
        self.recorder.record(rec)

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration instant event (chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        th = threading.current_thread()
        ev = {"ph": "i", "name": name, "ts": time.perf_counter_ns() / 1e3,
              "pid": self._pid, "tid": th.ident, "s": "t",
              "args": _clean_fields(attrs)}
        with self._lock:
            self._threads[th.ident] = th.name   # latest wins: the OS
            # recycles idents, and a stale name would mislabel the lane
            self._append(ev)
        self.recorder.record({"kind": "instant", "name": name,
                              "t_us": ev["ts"],
                              "attrs": ev["args"]})

    def _append(self, ev: dict) -> None:
        # caller holds the lock; the deque evicts the oldest itself
        if len(self._events) >= self.max_spans:
            self.dropped_spans += 1
        self._events.append(ev)

    def _record(self, name: str, t0_ns: int, dur_ns: int,
                attrs: dict) -> None:
        th = threading.current_thread()
        args = _clean_fields(attrs)
        ev = {"ph": "X", "name": name, "cat": "host",
              "ts": t0_ns / 1e3, "dur": dur_ns / 1e3,
              "pid": self._pid, "tid": th.ident, "args": args}
        with self._lock:
            self._threads[th.ident] = th.name   # latest wins (ident reuse)
            self._append(ev)
        self.recorder.record({"kind": "span", "name": name,
                              "t_us": ev["ts"], "dur_us": ev["dur"],
                              "thread": th.name, "attrs": args})
        led = self.ledger
        if led is not None:
            led.note_span(name, ev["ts"], ev["dur"],
                          step=args.get("step"))

    # -- ring-only notes (events / metric flushes from the registry) --------
    def note_event(self, name: str, step: Optional[int] = None,
                   fields: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self.recorder.record({"kind": "event", "name": name,
                              "step": None if step is None else int(step),
                              "fields": _clean_fields(fields)})
        led = self.ledger
        if led is not None:
            led.note_event(name, step=step, fields=fields)

    def note_flush(self, step: int, records: List[dict]) -> None:
        if not self.enabled:
            return
        names = sorted({r.get("name") for r in records
                        if isinstance(r.get("name"), str)})[:32]
        self.recorder.record({"kind": "metric_flush", "step": int(step),
                              "name": "registry.flush",
                              "n_records": len(records), "names": names})

    # -- export -------------------------------------------------------------
    def export(self) -> dict:
        """The Chrome-trace document (loads in chrome://tracing and
        Perfetto; :func:`load_chrome` reads it back)."""
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads)
        meta: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": self._pid,
             "args": {"name": self.process_name}}]
        for tid, tname in threads.items():
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": tname}})
        return {"displayTimeUnit": "ms",
                "droppedSpans": self.dropped_spans,
                "traceEvents": meta + events}

    def write(self, path: str) -> str:
        """Serialize :meth:`export` to ``path`` (gzip when it ends in
        ``.gz``).  Returns the path."""
        doc = self.export()
        opener = gzip.open if path.endswith(".gz") else open
        tmp = f"{path}.tmp{os.getpid()}"
        with opener(tmp, "wt") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self.recorder.clear()

    @property
    def n_spans(self) -> int:
        with self._lock:
            return sum(1 for e in self._events if e.get("ph") == "X")


# ---------------------------------------------------------------------------
# process-default tracer + library hook shims
# ---------------------------------------------------------------------------

_default: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process default the library hooks
    (guard, loader, DDP, registry) report into; None uninstalls.
    Returns the previous default so callers can restore it."""
    global _default
    prev = _default
    _default = tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _default


def active() -> bool:
    """True when a default tracer is installed and enabled — the fast
    guard every library hook checks first."""
    return _default is not None and _default.enabled


def span(name: str, **attrs):
    """Module-level span against the default tracer, mirrored into a
    recording profiler session (:func:`profiler_range` alone with no
    enabled tracer); the shared no-op singleton with neither.  NOTE:
    this resolves the tracer at CALL time — for decorating a function at
    import time use :func:`traced`, which resolves per call."""
    tr = _default
    if tr is not None and tr.enabled:
        return _Span(tr, name, attrs)
    return profiler_range(name)


def traced(name: Optional[str] = None, **attrs):
    """Decorator form: wraps ``fn`` in a span named ``name`` (default:
    the qualified function name), resolving the default tracer and the
    profiler's state at each call — safe to apply at import time before
    any tracer exists."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(label, **attrs):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def note_span(name: str, dur_s: float, **attrs) -> None:
    """Post-hoc span into the default tracer (no-op when none)."""
    tr = _default
    if tr is None or not tr.enabled:
        return
    tr.add(name, dur_s, **attrs)


def note_event(name: str, step: Optional[int] = None,
               fields: Optional[dict] = None) -> None:
    tr = _default
    if tr is None or not tr.enabled:
        return
    tr.note_event(name, step=step, fields=fields)


def note_flush(step: int, records: List[dict]) -> None:
    tr = _default
    if tr is None or not tr.enabled:
        return
    tr.note_flush(step, records)


def note_counter(name: str, step: Optional[int] = None,
                 values: Optional[dict] = None) -> None:
    """Counter-track sample into the default tracer (no-op when none)
    — the memory monitor's flush hook."""
    tr = _default
    if tr is None or not tr.enabled or not values:
        return
    tr.counter(name, step=step, **values)


def note_step(step: int, seconds: float, registry=None) -> None:
    """Registry step hook: records a ``train.step`` span and feeds the
    sentinel (if the tracer carries one).  ``registry`` is the stepping
    registry, threaded through so a sentinel fire's event lands in the
    run's OWN record stream, not just the process default."""
    tr = _default
    if tr is None or not tr.enabled:
        return
    tr.add("train.step", seconds, step=step)
    if tr.sentinel is not None:
        tr.sentinel.observe(step, seconds, tracer=tr, registry=registry)


# ---------------------------------------------------------------------------
# trace file -> span summary (the `python -m apex_tpu_torch.telemetry trace`
# CLI)
# ---------------------------------------------------------------------------

def load_chrome(path: str) -> List[dict]:
    """Load chrome-trace events from ``path``: a :meth:`Tracer.write`
    file, a profiler run dir (its newest trace file), or a *streaming*
    JSON-array file (events appended without ever closing the array, as
    the Trace Event Format allows).  Returns complete spans in the
    ``pyprof.parse`` event shape."""
    from ..pyprof import parse as _parse
    if os.path.isdir(path):
        return _parse.load(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        # streaming array (one record per appended line, never closed):
        # recover line by line, DROPPING an unparseable tail — a writer
        # killed mid-append (disk full, watcher host died) must lose
        # only its torn last record, never the hundreds of finished
        # spans before it
        data = []
        for line in text.splitlines():
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                data.append(json.loads(line))
            except ValueError:
                continue
        if not data:
            raise ValueError(
                f"{path}: neither complete JSON nor a streaming "
                "chrome-trace array") from None
    raw = data.get("traceEvents", []) if isinstance(data, dict) else data
    return _parse.events_from_chrome(raw)


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = max(0, min(len(sorted_vals) - 1,
                   int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[i]


def span_summary(events: List[dict]) -> List[dict]:
    """Per-name rollup over complete spans: count, total, SELF time
    (duration minus nested children, ``pyprof.parse._self_times``) with
    p50/p99
    over the per-span self times."""
    from ..pyprof import parse as _parse
    _parse._self_times(events)
    groups: Dict[str, List[dict]] = {}
    for e in events:
        groups.setdefault(e["name"], []).append(e)
    rows = []
    for name, evs in groups.items():
        selfs = sorted(max(e.get("self_us", e["dur"]), 0.0) for e in evs)
        rows.append({
            "name": name,
            "count": len(evs),
            "total_us": sum(e["dur"] for e in evs),
            "self_us": sum(selfs),
            "p50_self_us": _percentile(selfs, 0.50),
            "p99_self_us": _percentile(selfs, 0.99),
            "max_self_us": selfs[-1] if selfs else 0.0,
        })
    rows.sort(key=lambda r: -r["self_us"])
    total_self = sum(r["self_us"] for r in rows) or 1.0
    for r in rows:
        r["pct"] = 100.0 * r["self_us"] / total_self
    return rows


def format_span_summary(rows: List[dict], top: int = 25) -> str:
    """The span table: one sorted row per span name."""
    head = (f"{'span':<36} {'count':>6} {'total ms':>10} {'self ms':>10} "
            f"{'p50 us':>9} {'p99 us':>9} {'%':>6}")
    lines = [f"span timeline summary ({sum(r['count'] for r in rows)} "
             f"spans, {len(rows)} names)", head, "-" * len(head)]
    for r in rows[:top]:
        name = r["name"] if len(r["name"]) <= 36 else r["name"][:33] + "..."
        lines.append(
            f"{name:<36} {r['count']:>6} {r['total_us'] / 1e3:>10.3f} "
            f"{r['self_us'] / 1e3:>10.3f} {r['p50_self_us']:>9.1f} "
            f"{r['p99_self_us']:>9.1f} {r['pct']:>6.1f}")
    if len(rows) > top:
        rest = sum(r["self_us"] for r in rows[top:])
        lines.append(f"{'... ' + str(len(rows) - top) + ' more names':<36} "
                     f"{'':>6} {'':>10} {rest / 1e3:>10.3f}")
    return "\n".join(lines)


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry trace <file> [--top N]``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry trace",
        description="Render a span summary (per-name count/total/p50/p99 "
                    "self-time) from a chrome-trace file, a Tracer.write "
                    "export, or a torch.profiler run dir.")
    ap.add_argument("trace", help="trace file (.json / .json.gz) or "
                                  "profiler log dir")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    events = load_chrome(args.trace)
    if not events:
        print(f"no complete spans in {args.trace}")
        return 1
    dropped = getattr(events, "dropped_events", 0)
    if dropped:
        # a truncated capture must announce itself, not just render
        # thin
        print(f"WARNING: {dropped} trace events dropped "
              "(missing ts/dur — truncated capture?)")
    print(format_span_summary(span_summary(events), top=args.top))
    return 0
