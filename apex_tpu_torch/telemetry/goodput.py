"""Run-level goodput ledger: every wall-clock second of a run attributed
to exactly one class.

Counterpart of the JAX package's ``apex_tpu/telemetry/goodput.py``, with
its public names, classes, priority rules and ``GOODPUT.json`` schema (the
JAX ``goodput_violations`` accepts the port's artifacts).  A
:class:`GoodputLedger` attached to a :class:`~.trace.Tracer` takes every
completed span and counted event as it happens and partitions the run's
wall-clock by exact interval arithmetic (``telemetry.timeline``'s
``_clip`` / ``_merge`` / ``_subtract`` / ``_total_us``, as in the JAX
module).

The classes (each wall-clock second lands in exactly ONE)::

    productive      train.step + guard.health_check time that is NOT
                    replay and NOT carved out by a measured exposed-comm
                    decomposition
    exposed_comm    the measured exposed-collective share of step time,
                    carved out of ``productive`` when a device-timeline
                    decomposition was fed in (without one it reads 0)
    pipeline_bubble the pipeline fill/drain share of step time, fed by a
                    pipeline engine's static schedule (0 otherwise)
    data_stall      time the step boundary waited on data:
                    ``data.fetch`` and ``loader.wait`` spans
                    (``loader.fill`` runs beside the step and is never
                    charged)
    ckpt_exposed    checkpoint time the run waited on (``ckpt.exposed``),
                    not the background writer's ``ckpt.write``
    restore_replay  ``ckpt.restore``, ``guard.backoff``, and every step
                    span whose index does not pass the run's high-water
                    step after a rollback
    recompile       ``compile.*`` spans (the port compiles nothing, so
                    nothing emits them; the class reads 0)
    reshard         ``elastic.reshard`` + ``elastic.replan`` spans
    idle            everything else

Overlaps resolve by fixed priority (recompile > reshard > restore_replay
> ckpt_exposed > data_stall > exposed_comm > pipeline_bubble >
productive).  The partition is exact: ``sum(class ms) == wall ms`` up to
float rounding, asserted by :func:`goodput_violations`.  Installed as the
process default (:func:`install`), the ledger exports
``goodput.fraction`` and ``badput.*`` gauges at every ``Registry.flush``
(plain host floats: no device read).  ``python -m
apex_tpu_torch.telemetry goodput <jsonl|run-dir|GOODPUT.json>`` renders
it.  The ledger touches no device: every number is a host
``perf_counter`` microsecond.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from .timeline import _clip, _merge, _subtract, _total_us

__all__ = [
    "CLASSES", "BADPUT_CLASSES", "ABORT", "FAULT_BADPUT",
    "GoodputLedger", "goodput_violations", "install", "get_ledger",
    "summarize_records", "format_ledger", "load_artifact", "cli",
    "ARTIFACT_NAME",
]

#: the wall-clock partition, in ATTRIBUTION PRIORITY order (idle last:
#: it is defined as wall minus everything classified)
CLASSES = ("recompile", "reshard", "restore_replay", "ckpt_exposed",
           "data_stall", "exposed_comm", "pipeline_bubble", "productive",
           "idle")

#: every class except productive — what ``goodput.fraction`` excludes
BADPUT_CLASSES = tuple(c for c in CLASSES if c != "productive")

#: mapping value for fault kinds that terminate the run (OOM, an
#: injected collective failure, a checksum error): they produce a crash
#: artifact, not a badput interval in a surviving ledger
ABORT = "abort"

#: Every registered fault kind (``resilience.faults.KINDS``) declares
#: the badput class its injection is expected to land in — the contract
#: the chaos acceptance asserts, completeness-tested so a future fault
#: kind cannot ship without a ledger mapping (tier-1 fails otherwise).
FAULT_BADPUT = {
    # batch poisoning -> non-finite streak -> rollback + replay
    "nan": "restore_replay",
    "inf": "restore_replay",
    # snapshot-then-exit; the cost lands in the RESUMED run's restore
    "preempt": "restore_replay",
    # the loader's timed wait absorbs the injected sleep
    "loader_stall": "data_stall",
    # raises CollectiveFault at trace time — the run dies, no ledger class
    "collective_fail": ABORT,
    # post-mortem dump then re-raise, never a rollback
    "oom": ABORT,
    # snapshot-then-exit; the resumed run reshards through elastic
    "resize": "reshard",
    # typed ShardChecksumError — corrupt bytes never reach training
    "shard_corrupt": ABORT,
    # index loss degrades to a (slower, warned) directory scan
    "index_missing": "data_stall",
    # serving-plane fault: the training ledger never sees it (no train
    # step stalls), so any residue is idle here — the SERVE ledger
    # meters the real cost in its own ``shed`` class
    # (telemetry.serve_ledger)
    "request_flood": "idle",
    # persistent per-device slowdown: the controller quarantines the
    # named device through the elastic resize path, so the metered cost
    # is the replan+reshard of the resumed run — resize's class (the
    # injected in-step delay itself is slower productive time, which is
    # exactly what a real straggler costs)
    "straggler": "reshard",
    # sustained synthetic badput: the guard sleeps OUTSIDE any span, so
    # the ledger's exact partition attributes it to idle — the windowed
    # goodput_fraction drop the controller's floor policy watches
    "goodput_degrade": "idle",
}

#: span name -> ledger class.  Names NOT listed here (and not matching
#: a prefix below) are unattributed: their time lands in ``idle`` —
#: visible, never silently absorbed into productive.  ``ckpt.write``
#: and ``loader.fill`` are deliberately EXCLUDED (mapped to None):
#: they run on background threads and are overlapped by design; only
#: their exposed counterparts (``ckpt.exposed``, ``loader.wait``)
#: charge the wall.
SPAN_CLASSES: Dict[str, Optional[str]] = {
    "train.step": "productive",
    "guard.health_check": "productive",
    "data.fetch": "data_stall",
    "loader.wait": "data_stall",
    "ckpt.exposed": "ckpt_exposed",
    "ckpt.restore": "restore_replay",
    "guard.backoff": "restore_replay",
    "elastic.reshard": "reshard",
    "elastic.replan": "reshard",
    "ckpt.write": None,
    "loader.fill": None,
}

#: span-name prefixes (checked after the exact table): the compile
#: listener emits ``compile.<phase>`` post-hoc spans
_PREFIX_CLASSES: Tuple[Tuple[str, str], ...] = (("compile.", "recompile"),)

#: the span names whose ``step`` attr drives replay bookkeeping
_STEP_SPANS = frozenset(("train.step", "guard.health_check"))

#: the event names the ledger counts (the replay-iff-rollbacks proof
#: and the rendered counts line both read these)
_COUNTED_EVENTS = ("rollback", "resumed", "preempted", "fault_injected",
                   "elastic.reshard", "elastic.replan")

#: the canonical artifact filename the guard writes and the CLI /
#: watcher stage look for in a run directory
ARTIFACT_NAME = "GOODPUT.json"


def span_class(name: str) -> Optional[str]:
    """The ledger class for one span name (None = unattributed)."""
    if name in SPAN_CLASSES:
        return SPAN_CLASSES[name]
    for prefix, cls in _PREFIX_CLASSES:
        if name.startswith(prefix):
            return cls
    return None


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class GoodputLedger:
    """Accumulates classified host-time intervals and partitions the
    run's wall-clock exactly.  See the module docstring for the class
    definitions and priority rules.

    Usage (the guard does all of this automatically)::

        led = goodput.GoodputLedger()
        led.attach(tracer)          # spans stream in live
        prev = goodput.install(led) # Registry.flush exports gauges
        ... the run ...
        led.detach(tracer); goodput.install(prev)
        doc = led.snapshot()        # the partition
        led.write(directory=run_dir)  # GOODPUT.json

    ``max_intervals`` bounds the per-class interval store (drop-oldest,
    counted in ``dropped_intervals`` — the tracer's visible-loss
    posture).  A ``enabled=False`` ledger is a true no-op.
    """

    def __init__(self, *, enabled: bool = True,
                 max_intervals: int = 200_000):
        self.enabled = bool(enabled)
        self.max_intervals = int(max_intervals)
        self.t0_us = _now_us()
        self.dropped_intervals = 0
        self._n_intervals = 0
        # raw classified intervals: class -> [(t0_us, t1_us), ...]
        self._raw: Dict[str, List[Tuple[float, float]]] = {
            c: [] for c in CLASSES if c != "idle"}
        # (t0, t1, step) for productive step/health spans — the
        # decomposition carve and the replay split both need the tag
        self._step_spans: List[Tuple[float, float, int]] = []
        self._high_water = -1
        self._replay_until = -1
        self._steps_seen = 0
        self._replayed_steps = 0
        self.counts: Dict[str, int] = {
            "rollbacks": 0, "resumes": 0, "preempts": 0, "reshards": 0,
            "replans": 0, "compiles": 0, "faults_injected": 0}
        # step -> exposed_comm fraction of that step's device time, fed
        # from a timeline decomposition (None until a capture exists)
        self._exposed_frac: Optional[Dict[int, float]] = None
        self._exposed_default: Optional[float] = None
        # the pp engine's static fill/drain fraction ((S-1)/(M+S-1));
        # 0.0 until a pipeline plan feeds it — non-pp runs stay honest
        self._bubble_frac: float = 0.0

    # -- ingestion (called from the Tracer hook; host floats only) ----------
    def note_span(self, name: str, t_us: float, dur_us: float,
                  step: Optional[int] = None) -> None:
        if not self.enabled or dur_us <= 0:
            return
        cls = span_class(name)
        if cls is None:
            return
        if self._n_intervals >= self.max_intervals:
            self.dropped_intervals += 1
            return
        t1 = t_us + dur_us
        if cls == "productive" and name in _STEP_SPANS:
            s = int(step) if isinstance(step, (int, float)) else -1
            if name == "train.step" and s >= 0:
                self._steps_seen += 1
                if s <= self._replay_until:
                    self._replayed_steps += 1
                self._high_water = max(self._high_water, s)
            if 0 <= s <= self._replay_until:
                # re-stepped ground between a rollback restore and the
                # previously-reached step: replay, not productive
                self._raw["restore_replay"].append((t_us, t1))
                self._n_intervals += 1
                return
            self._step_spans.append((t_us, t1, s))
        self._raw[cls].append((t_us, t1))
        self._n_intervals += 1
        if name == "ckpt.restore":
            # a rollback restore re-arms the replay window up to the
            # high-water step this run already reached (a plain resume
            # restore in a fresh process has high_water -1: no replay)
            self._replay_until = self._high_water
        elif cls == "recompile":
            self.counts["compiles"] += 1

    def note_event(self, name: str, step: Optional[int] = None,
                   fields: Optional[dict] = None) -> None:
        if not self.enabled or name not in _COUNTED_EVENTS:
            return
        key = {"rollback": "rollbacks", "resumed": "resumes",
               "preempted": "preempts", "fault_injected": "faults_injected",
               "elastic.reshard": "reshards",
               "elastic.replan": "replans"}[name]
        self.counts[key] += 1

    def set_decomposition(self, decomp: dict) -> None:
        """Feed a device-timeline decomposition
        (:func:`.timeline.decompose`; the slow-step sentinel feeds its
        capture's) so the measured exposed-comm share is carved out of
        productive step time — per step where the capture has that step's window,
        via the capture's overall fraction otherwise."""
        if not self.enabled or not isinstance(decomp, dict):
            return
        totals = decomp.get("totals") or {}
        frac = totals.get("exposed_comm_fraction")
        per_step: Dict[int, float] = {}
        for s in decomp.get("steps") or ():
            devs = list((s.get("devices") or {}).values())
            if not devs:
                continue
            busy = sum(d.get("busy_ms", 0.0) for d in devs)
            exposed = sum(d.get("exposed_comm_ms", 0.0) for d in devs)
            if busy > 0:
                per_step[int(s.get("step", -1))] = exposed / busy
        self._exposed_frac = per_step or None
        self._exposed_default = float(frac) if isinstance(
            frac, (int, float)) else None

    def set_pipeline_bubble(self, fraction) -> None:
        """Feed the pp engine's STATIC fill/drain fraction
        ((S-1)/(M+S-1)) so that share of every productive
        step span is carved into the ``pipeline_bubble`` class.  Never
        called on a non-pp run: the class honestly reads 0 there."""
        if not self.enabled:
            return
        f = float(fraction or 0.0)
        self._bubble_frac = min(max(f, 0.0), 1.0)

    # -- the partition -------------------------------------------------------
    def snapshot(self, *, now_us: Optional[float] = None,
                 status: Optional[str] = None) -> dict:
        """The exact wall-clock partition as a JSON-serializable doc.
        Priority subtraction (CLASSES order) guarantees every second
        lands in exactly one class; ``idle`` is the unclassified rest,
        so the classes sum to the wall up to float rounding
        (``partition_error_ms``, asserted ~0 by
        :func:`goodput_violations`)."""
        t1 = self.t0_us + 0.0 if not self.enabled else (
            _now_us() if now_us is None else float(now_us))
        t0 = self.t0_us
        wall_us = max(t1 - t0, 0.0)
        merged: Dict[str, List[Tuple[float, float]]] = {}
        for cls in CLASSES:
            if cls == "idle":
                continue
            merged[cls] = _merge(_clip(self._raw[cls], t0, t1))
        # the exposed-comm carve: a measured decomposition splits each
        # productive step interval into exposed vs the rest, BEFORE the
        # cross-class priority subtraction
        if self._exposed_frac is not None or self._exposed_default:
            carved: List[Tuple[float, float]] = []
            for (s0, s1, step) in self._step_spans:
                f = (self._exposed_frac or {}).get(step,
                                                   self._exposed_default)
                if f and f > 0:
                    carved.append((s0, s0 + min(f, 1.0) * (s1 - s0)))
            if carved:
                merged["exposed_comm"] = _merge(
                    merged["exposed_comm"] + _clip(carved, t0, t1))
        # the pipeline-bubble carve: the pp engine's static fill/drain
        # share of each productive step span, taken from the END of the
        # span (the exposed-comm carve takes the start, so the two
        # overlap as little as possible; any residual overlap resolves
        # by the priority subtraction below — the partition stays exact)
        if self._bubble_frac > 0:
            f = self._bubble_frac
            bubbled = [(s1 - f * (s1 - s0), s1)
                       for (s0, s1, _s) in self._step_spans]
            if bubbled:
                merged["pipeline_bubble"] = _merge(
                    merged["pipeline_bubble"] + _clip(bubbled, t0, t1))
        # priority subtraction: class k keeps what no higher class claims
        claimed: List[Tuple[float, float]] = []
        parts: Dict[str, float] = {}
        for cls in CLASSES:
            if cls == "idle":
                continue
            own = _subtract(merged[cls], claimed)
            parts[cls] = _total_us(own)
            claimed = _merge(claimed + own)
        parts["idle"] = _total_us(
            _subtract([(t0, t1)] if wall_us > 0 else [], claimed))
        total_us = sum(parts.values())
        classes = {}
        for cls in CLASSES:
            ms = parts[cls] / 1e3
            classes[cls] = {
                "ms": round(ms, 6),
                "fraction": round(parts[cls] / wall_us, 6) if wall_us > 0
                else 0.0,
            }
        doc = {
            "kind": "goodput_ledger",
            "version": 1,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "wall_ms": round(wall_us / 1e3, 6),
            "goodput_fraction": classes["productive"]["fraction"],
            "classes": classes,
            "partition_error_ms": round(abs(wall_us - total_us) / 1e3, 9),
            "steps": self._steps_seen,
            "replayed_steps": self._replayed_steps,
            "counts": dict(self.counts),
            "dropped_intervals": self.dropped_intervals,
        }
        if status is not None:
            doc["status"] = str(status)
        return doc

    # -- exports -------------------------------------------------------------
    def observe(self, registry, doc: Optional[dict] = None) -> None:
        """Export the current partition through ``registry`` as plain-
        float gauges (they resolve in the registry's ONE batched flush
        read, adding no host sync): ``goodput.fraction`` /
        ``goodput.wall_ms`` / ``goodput.productive_ms`` plus one
        ``badput.<class>_ms`` gauge per badput class."""
        if registry is None or not getattr(registry, "enabled", False) \
                or not self.enabled:
            return
        if doc is None:
            doc = self.snapshot()
        registry.gauge("goodput.fraction").set(doc["goodput_fraction"])
        registry.gauge("goodput.wall_ms").set(doc["wall_ms"])
        registry.gauge("goodput.productive_ms").set(
            doc["classes"]["productive"]["ms"])
        for cls in BADPUT_CLASSES:
            registry.gauge(f"badput.{cls}_ms").set(
                doc["classes"][cls]["ms"])

    def observe_flush(self, registry) -> None:
        """The ``Registry.flush`` hook (mirrors
        ``memory.MemoryMonitor.observe_flush``): refresh the gauges
        inside the flush's batched host window so a live run's JSONL
        carries the running ledger, not just the exit snapshot."""
        self.observe(registry)

    # -- tracer plumbing -----------------------------------------------------
    def attach(self, tracer) -> None:
        """Stream ``tracer``'s spans/events into this ledger (one
        attribute check per span when detached — the hook cost the
        tracer already pays for the recorder)."""
        if tracer is not None:
            tracer.ledger = self

    def detach(self, tracer) -> None:
        if tracer is not None and getattr(tracer, "ledger", None) is self:
            tracer.ledger = None

    # -- the artifact --------------------------------------------------------
    def write(self, path: Optional[str] = None,
              directory: Optional[str] = None,
              doc: Optional[dict] = None) -> Optional[str]:
        """Write the ledger doc as ``GOODPUT.json`` (atomic replace,
        writer-validates — the JsonlSink posture).  ``path`` wins over
        ``directory``/``ARTIFACT_NAME``; with neither, returns None (a
        ledger without a home must not litter the cwd)."""
        if doc is None:
            doc = self.snapshot()
        bad = goodput_violations(doc)
        if bad:
            raise ValueError("goodput ledger fails its schema: "
                             + "; ".join(bad[:4]))
        if path is None:
            if directory is None:
                return None
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, ARTIFACT_NAME)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# process-default ledger (the Registry.flush export hook)
# ---------------------------------------------------------------------------

_installed: Optional[GoodputLedger] = None


def install(ledger: Optional[GoodputLedger]) -> Optional[GoodputLedger]:
    """Install ``ledger`` as the process default ``Registry.flush``
    exports gauges from (None uninstalls).  Returns the previous one so
    callers (the guard) can restore it."""
    global _installed
    prev = _installed
    _installed = ledger
    return prev


def get_ledger() -> Optional[GoodputLedger]:
    return _installed


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

_is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
_is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)

#: the absolute partition slack (ms): float rounding over the interval
#: sums, never a real unattributed gap
_PARTITION_TOL_MS = 1e-3


def goodput_violations(doc: Any) -> List[str]:
    """Schema complaints for a goodput ledger doc (empty = valid).
    The load-bearing checks: the classes PARTITION the wall exactly
    (sum == wall up to float rounding), every fraction is in [0, 1],
    and replay badput is present iff a restore was metered (rollbacks
    imply replay time; replay time implies a rollback or resume)."""
    if not isinstance(doc, dict):
        return [f"doc is not an object: {type(doc).__name__}"]
    out = []
    if doc.get("kind") != "goodput_ledger":
        out.append(f"bad kind {doc.get('kind')!r}")
    if doc.get("version") != 1:
        out.append(f"unknown version {doc.get('version')!r}")
    wall = doc.get("wall_ms")
    if not _is_num(wall) or wall < 0:
        out.append(f"bad wall_ms {wall!r}")
        wall = None
    classes = doc.get("classes")
    if not isinstance(classes, dict):
        return out + ["classes must be a dict"]
    if set(classes) != set(CLASSES):
        out.append(f"classes keys off-schema: have {sorted(classes)}, "
                   f"want {sorted(CLASSES)}")
        return out
    total_ms = 0.0
    total_frac = 0.0
    for cls, row in classes.items():
        if not isinstance(row, dict) or not _is_num(row.get("ms")) \
                or not _is_num(row.get("fraction")):
            out.append(f"classes.{cls}: needs numeric ms + fraction")
            continue
        if row["ms"] < -_PARTITION_TOL_MS:
            out.append(f"classes.{cls}: negative ms {row['ms']}")
        if not (-1e-6 <= row["fraction"] <= 1.0 + 1e-6):
            out.append(f"classes.{cls}: fraction {row['fraction']} "
                       "outside [0, 1]")
        total_ms += row["ms"]
        total_frac += row["fraction"]
    if wall is not None:
        tol = max(_PARTITION_TOL_MS, 1e-6 * wall)
        if abs(total_ms - wall) > tol:
            out.append(f"classes do not partition the wall: sum "
                       f"{total_ms} ms vs wall {wall} ms")
        if wall > 0 and abs(total_frac - 1.0) > 1e-3:
            out.append(f"class fractions sum to {total_frac}, not 1")
    gf = doc.get("goodput_fraction")
    if not _is_num(gf) or not (-1e-6 <= gf <= 1.0 + 1e-6):
        out.append(f"bad goodput_fraction {gf!r}")
    elif isinstance(classes.get("productive"), dict) and _is_num(
            classes["productive"].get("fraction")) and \
            abs(gf - classes["productive"]["fraction"]) > 1e-6:
        out.append("goodput_fraction != productive fraction")
    pe = doc.get("partition_error_ms")
    if not _is_num(pe) or pe > _PARTITION_TOL_MS:
        out.append(f"bad/oversized partition_error_ms {pe!r}")
    counts = doc.get("counts")
    if not (isinstance(counts, dict)
            and all(_is_int(v) for v in counts.values())):
        out.append("counts must be a dict of ints")
    else:
        replay_ms = (classes.get("restore_replay") or {}).get("ms")
        if _is_num(replay_ms):
            restores = counts.get("rollbacks", 0) + counts.get("resumes", 0)
            if counts.get("rollbacks", 0) > 0 and replay_ms <= 0:
                out.append("rollbacks metered but restore_replay badput "
                           "is 0 — replay time went unattributed")
            if replay_ms > 0 and restores == 0:
                out.append(f"restore_replay {replay_ms} ms with no "
                           "rollback/resume metered")
    for key in ("steps", "replayed_steps", "dropped_intervals"):
        if not _is_int(doc.get(key)) or doc[key] < 0:
            out.append(f"bad/missing {key!r}: {doc.get(key)!r}")
    return out


# ---------------------------------------------------------------------------
# JSONL summary (the run's exported gauges -> the same rendered table)
# ---------------------------------------------------------------------------

def summarize_records(records) -> Optional[dict]:
    """Rebuild a ledger-shaped summary from a run's telemetry JSONL —
    the ``goodput.*``/``badput.*`` gauges the ledger exported through
    the batched flush.  Returns None when the stream carries no
    goodput gauges (a pre-ledger or unguarded run)."""
    gauges: Dict[str, float] = {}
    events: Dict[str, int] = {}
    for rec in records:
        if rec.get("kind") == "metric" and rec.get("type") == "gauge" \
                and isinstance(rec.get("name"), str) \
                and (rec["name"].startswith("goodput.")
                     or rec["name"].startswith("badput.")):
            gauges[rec["name"]] = rec.get("value")
        elif rec.get("kind") == "event":
            events[rec.get("name")] = events.get(rec.get("name"), 0) + 1
    if "goodput.fraction" not in gauges:
        return None
    wall = gauges.get("goodput.wall_ms", 0.0) or 0.0
    classes = {}
    for cls in CLASSES:
        ms = (gauges.get("goodput.productive_ms", 0.0)
              if cls == "productive"
              else gauges.get(f"badput.{cls}_ms", 0.0)) or 0.0
        classes[cls] = {"ms": round(ms, 6),
                        "fraction": round(ms / wall, 6) if wall else 0.0}
    return {
        "kind": "goodput_ledger",
        "version": 1,
        "source": "jsonl",
        "wall_ms": wall,
        "goodput_fraction": gauges["goodput.fraction"],
        "classes": classes,
        "partition_error_ms": 0.0,
        "steps": 0,
        "replayed_steps": 0,
        "counts": {"rollbacks": events.get("rollback", 0),
                   "resumes": events.get("resumed", 0),
                   "preempts": events.get("preempted", 0),
                   "reshards": events.get("elastic.reshard", 0),
                   "replans": events.get("elastic.replan", 0),
                   "compiles": 0,
                   "faults_injected": events.get("fault_injected", 0)},
        "dropped_intervals": 0,
    }


# ---------------------------------------------------------------------------
# rendering / CLI
# ---------------------------------------------------------------------------

def format_ledger(doc: dict) -> str:
    """The human form: goodput fraction, the per-class ledger table
    (every wall-clock ms in exactly one row), and the lifecycle
    counts."""
    wall = doc.get("wall_ms", 0.0)
    lines = [f"goodput ledger  (wall {wall:.1f} ms"
             + (f", status {doc['status']}" if doc.get("status") else "")
             + ")",
             f"  goodput.fraction    {doc.get('goodput_fraction', 0.0):.4f}"]
    head = f"  {'class':<16}{'ms':>12}{'% of wall':>11}"
    lines += [head, "  " + "-" * (len(head) - 2)]
    for cls in CLASSES:
        row = doc["classes"][cls]
        lines.append(f"  {cls:<16}{row['ms']:>12.3f}"
                     f"{100.0 * row['fraction']:>10.2f}%")
    lines.append(f"  {'(partition error':<16}{doc.get('partition_error_ms', 0.0):>12.6f} ms)")
    counts = doc.get("counts") or {}
    nz = [f"{k.replace('_', ' ')} {v}" for k, v in counts.items() if v]
    if nz:
        lines.append("  counts: " + "  ".join(nz))
    if doc.get("steps"):
        lines.append(f"  steps: {doc['steps']}"
                     + (f" ({doc['replayed_steps']} replayed)"
                        if doc.get("replayed_steps") else ""))
    if doc.get("dropped_intervals"):
        lines.append(f"  WARNING: {doc['dropped_intervals']} intervals "
                     "dropped (ledger cap) — classes under-count")
    return "\n".join(lines)


def load_artifact(path: str) -> dict:
    """Load a ledger doc from ``path``: a ``GOODPUT.json`` file, a run
    directory containing one, or a telemetry JSONL whose gauges carry
    the exported ledger.  Raises ValueError when none of the shapes
    match (the CLI's rc=1)."""
    if os.path.isdir(path):
        cand = os.path.join(path, ARTIFACT_NAME)
        if not os.path.exists(cand):
            raise ValueError(f"{path}: no {ARTIFACT_NAME} in directory")
        path = cand
    with open(path) as f:
        head = f.read(4096)
    if head.lstrip().startswith("{"):
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError:
            doc = None
        if isinstance(doc, dict) and doc.get("kind") == "goodput_ledger":
            return doc
    # fall through: treat as a telemetry JSONL (torn/partial tolerated
    # — load_records skips bad lines)
    from .report import load_records
    doc = summarize_records(load_records(path))
    if doc is None:
        raise ValueError(f"{path}: neither a goodput ledger artifact nor "
                         "a JSONL carrying goodput gauges")
    return doc


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry goodput
    <jsonl|run-dir|GOODPUT.json>``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry goodput",
        description="Render the run-level goodput ledger (wall-clock "
                    "badput attribution) from a GOODPUT.json artifact, a "
                    "run directory holding one, or a telemetry JSONL "
                    "whose gauges carry the exported ledger.")
    ap.add_argument("path", help="GOODPUT.json, a run dir, or a "
                                 "telemetry JSONL")
    ap.add_argument("--json", action="store_true",
                    help="print the ledger doc as one JSON document")
    args = ap.parse_args(argv)
    try:
        doc = load_artifact(args.path)
    except (OSError, ValueError) as err:
        print(f"goodput: {err}")
        return 1
    bad = goodput_violations(doc) if doc.get("source") != "jsonl" else []
    if args.json:
        print(json.dumps(doc))
    else:
        print(format_ledger(doc))
    if bad:
        print("SCHEMA VIOLATIONS:\n  " + "\n  ".join(bad))
        return 1
    return 0
