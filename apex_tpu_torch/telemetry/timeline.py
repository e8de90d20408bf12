"""Device-timeline observability: exposed-comm accounting, per-device step
decomposition, and straggler detection.

Counterpart of the JAX package's ``apex_tpu/telemetry/timeline.py``, with
its public names and its ``device_timeline`` document.  The spans and
meters of the rest of this package are host-side: they say what ran, not
what the device was doing, nor how much collective time was EXPOSED
(serialized after compute) rather than hidden behind it.  This module
reads a ``torch.profiler`` (Kineto) capture, written by
:func:`apex_tpu_torch.pyprof.trace`, and answers that:

  * :func:`device_lanes` -- the device's work per card: Kineto's
    ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events, every stream of
    one device merged into one lane (``GPU:<device>``), since exposed-comm
    subtraction is a same-DEVICE property.  A trace without Kineto
    categories (the JAX package's synthetic and XLA lanes) takes the JAX
    rules: device-named processes, then HLO-shaped lanes;
  * :func:`event_op_class` -- the :data:`~.attrib.OP_CLASSES` bin of a
    device event: a CUDA kernel by its name (``nccl*`` collective,
    cuBLAS / cuBLASLt / CUTLASS GEMMs blas, cuDNN convolutions conv,
    copies and fills memory, the port's own kernels other, the rest
    pointwise), an HLO op by its opcode;
  * :func:`step_windows` -- the device's step windows: the
    ``gpu_user_annotation`` events Kineto mirrors from a
    ``record_function("train.step")`` range onto the streams its
    launches went to (a host span's window says when the host enqueued
    the step, not when the device ran it); host spans only where no
    device window exists (a CPU capture), else the whole device extent;
  * :func:`decompose` -- per device, per step: compute ms, collective
    ms, **exposed collective ms** (collective intervals not covered by
    same-device compute, by exact interval subtraction) and idle ms;
    cross-device skew and leave-one-out straggler z-scores
    (:func:`straggler_rows`);
  * :func:`observe` -- the ``step.device_compute_ms`` /
    ``step.exposed_comm_ms`` / ``step.device_idle_ms`` gauges through a
    :class:`~.registry.Registry` and one ``timeline.straggler`` event per
    flagged row;
  * :func:`merge_host_device` -- host Tracer spans and the device lanes
    in ONE Chrome timeline on a shared epoch, aligned on the spans a
    profiler session mirrored (:func:`mirror_offset`);
  * :func:`port_launches` -- the port's kernel launches per step window,
    found by their CUDA function names;
  * :func:`cli` -- ``python -m apex_tpu_torch.telemetry timeline
    <trace|profiler-dir>``.

All math is exact interval arithmetic over the trace's microsecond
timestamps (the ``_merge`` / ``_subtract`` / ``_clip`` / ``_total_us``
core is the goodput ledger's too).  Nothing here touches the device.
"""
from __future__ import annotations

import json
import math
import re
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from .attrib import hlo_op_class, kernel_op_class

__all__ = [
    "device_lanes", "event_op_class", "is_collective_event",
    "step_windows", "decompose", "straggler_rows", "observe",
    "merge_host_device", "mirror_offset", "load_events", "summarize",
    "format_decomposition", "port_launches", "cli",
    "STRAGGLER_Z", "STRAGGLER_MIN_SLOWDOWN", "DEVICE_CATS",
]

#: leave-one-out z-score a device's per-step busy time must exceed --
#: AND be at least STRAGGLER_MIN_SLOWDOWN x the rest-of-mesh mean
STRAGGLER_Z = 3.0
STRAGGLER_MIN_SLOWDOWN = 1.2

#: the std floor for the leave-one-out z (relative to the rest-mean)
_Z_STD_FLOOR_FRAC = 0.02

#: Kineto's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Kineto's category of a host range mirrored onto a stream
_DEVICE_RANGE_CAT = "gpu_user_annotation"

# ---------------------------------------------------------------------------
# lane detection + event classification
# ---------------------------------------------------------------------------

#: process names an XLA export gives device timelines ("/device:TPU:0",
#: "TPU:0", "/device:GPU:0", ...)
_DEVICE_PROC_RE = re.compile(r"(/device:(?!CPU)|^TPU[: ]|^GPU[: ])",
                             re.IGNORECASE)

#: an HLO-shaped span name: "all-reduce.3", "fusion.12", "dot", ...
_HLO_NAME_RE = re.compile(r"^%?([a-z][a-z0-9_\-]*?)(?:\.\d+)?$")

#: opcodes that hint a lane is a device op timeline even when the exporter
#: did not name its process "/device:..."
_HLO_HINT = frozenset((
    "fusion", "dot", "convolution", "add", "multiply", "subtract",
    "divide", "exp", "exponential", "log", "tanh", "rsqrt", "sqrt",
    "power", "negate", "select", "compare", "maximum", "minimum",
    "convert", "copy", "transpose", "broadcast", "reshape", "slice",
    "concatenate", "pad", "gather", "scatter", "dynamic-slice",
    "dynamic-update-slice", "iota", "reduce", "reduce-window",
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "send", "recv",
    "custom-call", "while", "sort", "bitcast", "tuple", "rng",
))


def _base_opcode(name: str) -> Optional[str]:
    """``"all-reduce-start.3"`` -> ``"all-reduce"``; None when the name
    is not HLO-shaped."""
    m = _HLO_NAME_RE.match(name.strip())
    if not m:
        return None
    base = m.group(1)
    for suffix in ("-start", "-done"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base


def _is_hlo_hint(name: str) -> bool:
    base = _base_opcode(name)
    if base is None:
        return False
    return base in _HLO_HINT or base.endswith("fusion")


def event_op_class(name: str, cat: Optional[str] = None) -> Optional[str]:
    """The :data:`~.attrib.OP_CLASSES` bin of one device event, or None
    for a span that is no device op.  A Kineto device event (``cat`` one
    of :data:`DEVICE_CATS`) bins by its CUDA kernel name
    (:func:`~.attrib.kernel_op_class`); anything else by its HLO opcode,
    as the JAX package bins it (``fusion`` as pointwise)."""
    if cat in DEVICE_CATS:
        return kernel_op_class(name, cat)
    base = _base_opcode(name)
    if base is None:
        return None
    return hlo_op_class(base)


def is_collective_event(name: str, cat: Optional[str] = None) -> bool:
    return event_op_class(name, cat) == "collective"


def _event_class(e: dict) -> Optional[str]:
    return event_op_class(e["name"], e.get("cat"))


def _device_of(e: dict):
    dev = (e.get("args") or {}).get("device")
    return e.get("pid") if dev is None else dev


def device_lanes(events: Sequence[dict]) -> Dict[str, List[dict]]:
    """Per-device event lists from parsed trace events (the
    ``pyprof.parse`` shape).  Kineto first: every ``kernel`` /
    ``gpu_memcpy`` / ``gpu_memset`` event lands in lane
    ``GPU:<device>``, all streams of that device merged.  Without any,
    the JAX rules: every process whose display name looks like a device
    timeline is one lane, all its threads merged; failing that, any
    (process, thread) lane where at least half the span names parse as
    HLO opcodes, named ``process:thread``."""
    kin: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            kin.setdefault(f"GPU:{_device_of(e)}", []).append(e)
    if kin:
        return {k: sorted(v, key=lambda e: e["ts"])
                for k, v in sorted(kin.items())}
    by_proc: Dict[str, List[dict]] = {}
    for e in events:
        proc = str(e.get("process", e.get("pid")))
        if _DEVICE_PROC_RE.search(proc):
            by_proc.setdefault(proc, []).append(e)
    if by_proc:
        return {k: sorted(v, key=lambda e: e["ts"])
                for k, v in sorted(by_proc.items())}
    from ..pyprof.parse import _NOISE_PREFIXES
    by_lane: Dict[Tuple, List[dict]] = {}
    for e in events:
        by_lane.setdefault((str(e.get("process")), str(e.get("thread"))),
                           []).append(e)
    out: Dict[str, List[dict]] = {}
    for (proc, thread), evs in sorted(by_lane.items()):
        considered = [e for e in evs
                      if "::" not in e["name"]
                      and not e["name"].startswith(_NOISE_PREFIXES)]
        hlo = sum(1 for e in considered if _is_hlo_hint(e["name"]))
        if hlo and hlo * 2 >= len(considered):
            out[f"{proc}:{thread}"] = sorted(evs, key=lambda e: e["ts"])
    return out


# ---------------------------------------------------------------------------
# exact interval arithmetic (all times in trace microseconds)
# ---------------------------------------------------------------------------

def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted union of half-open intervals (empty/negative spans drop)."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _subtract(a: List[Tuple[float, float]],
              b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``a - b`` for MERGED interval lists: the parts of ``a`` no
    interval of ``b`` covers -- the exposed-comm core."""
    out: List[Tuple[float, float]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _clip(intervals: List[Tuple[float, float]], t0: float,
          t1: float) -> List[Tuple[float, float]]:
    return [(max(s, t0), min(e, t1)) for s, e in intervals
            if e > t0 and s < t1]


def _total_us(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


# ---------------------------------------------------------------------------
# step windows
# ---------------------------------------------------------------------------

#: span names that delimit one training step (``Registry.step()`` and
#: ``pyprof.annotate("train.step")`` emit ``train.step``)
_STEP_SPAN_NAMES = frozenset(("train.step", "bench.step", "step"))


def _marks(spans) -> List[Tuple[int, float, float]]:
    marks = []
    for ts, end, step in spans:
        marks.append((int(step) if isinstance(step, (int, float))
                      else len(marks), ts, end))
    return sorted(marks, key=lambda w: w[1])


def step_windows(events: Sequence[dict]) -> List[Tuple[int, float, float]]:
    """``(step, t0_us, t1_us)`` windows to decompose against.  Device
    windows first: the ``gpu_user_annotation`` mirrors of a step range,
    one window per host range (its ``External id``) spanning its mirrors
    on every stream.  Else host step spans (merged timelines and CPU
    captures carry them); else the whole device extent is ONE window
    (step 0)."""
    mirrors: Dict = {}
    for i, e in enumerate(events):
        if (e.get("cat") == _DEVICE_RANGE_CAT
                and e.get("name") in _STEP_SPAN_NAMES
                and e.get("dur", 0) > 0):
            args = e.get("args") or {}
            key = args.get("External id", ("event", i))
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            if key in mirrors:
                a, b, step = mirrors[key]
                mirrors[key] = (min(a, t0), max(b, t1), step)
            else:
                mirrors[key] = (t0, t1, args.get("step"))
    if mirrors:
        return _marks(sorted(mirrors.values()))
    spans = []
    for e in events:
        if (e.get("name") in _STEP_SPAN_NAMES and e.get("dur", 0) > 0
                and e.get("cat") != _DEVICE_RANGE_CAT):
            spans.append((e["ts"], e["ts"] + e["dur"],
                          (e.get("args") or {}).get("step")))
    if spans:
        return _marks(spans)
    lanes = device_lanes(events)
    work = [e for evs in lanes.values() for e in evs]
    if not work:
        return []
    t0 = min(e["ts"] for e in work)
    t1 = max(e["ts"] + e["dur"] for e in work)
    return [(0, t0, t1)]


# ---------------------------------------------------------------------------
# the decomposition
# ---------------------------------------------------------------------------

def decompose(events: Sequence[dict],
              windows: Optional[List[Tuple[int, float, float]]] = None, *,
              z_threshold: float = STRAGGLER_Z,
              min_slowdown: float = STRAGGLER_MIN_SLOWDOWN) -> dict:
    """Per-device, per-step decomposition of a parsed device trace.

    For each device lane and step window: ``compute_ms`` (union of
    non-collective device intervals), ``comm_ms`` (union of collective
    intervals), ``exposed_comm_ms`` (collective minus compute, exact
    interval subtraction), ``busy_ms`` (union of both) and ``idle_ms``
    (window minus busy: host stalls, syncs, launch gaps).  Cross-device:
    per-step ``skew_ms`` (max - min busy) and straggler rows.  Returns a
    JSON-serializable dict, the JAX package's ``device_timeline``
    document."""
    lanes = device_lanes(events)
    if windows is None:
        windows = step_windows(events)
    per_lane = {
        dev: {
            "comm": _merge([(e["ts"], e["ts"] + e["dur"]) for e in evs
                            if _event_class(e) == "collective"]),
            "compute": _merge([(e["ts"], e["ts"] + e["dur"]) for e in evs
                               if _event_class(e)
                               not in (None, "collective")]),
        }
        for dev, evs in lanes.items()
    }
    steps = []
    for step, t0, t1 in windows:
        devs = {}
        for dev, iv in per_lane.items():
            comm = _clip(iv["comm"], t0, t1)
            compute = _clip(iv["compute"], t0, t1)
            exposed = _subtract(comm, compute)
            busy = _merge(comm + compute)
            row = {
                "compute_ms": _total_us(compute) / 1e3,
                "comm_ms": _total_us(comm) / 1e3,
                "exposed_comm_ms": _total_us(exposed) / 1e3,
                "busy_ms": _total_us(busy) / 1e3,
                "idle_ms": max(t1 - t0 - _total_us(busy), 0.0) / 1e3,
            }
            devs[dev] = {k: round(v, 6) for k, v in row.items()}
        busys = [d["busy_ms"] for d in devs.values()]
        steps.append({
            "step": int(step),
            "t0_us": float(t0),
            "dur_ms": round((t1 - t0) / 1e3, 6),
            "devices": devs,
            "skew_ms": round(max(busys) - min(busys), 6) if busys else 0.0,
        })
    stragglers = straggler_rows(steps, z_threshold=z_threshold,
                                min_slowdown=min_slowdown)
    per_device = {}
    for dev in lanes:
        rows = [s["devices"][dev] for s in steps if dev in s["devices"]]
        zs = [r["z"] for r in stragglers if r["device"] == dev]
        per_device[dev] = {
            "steps": len(rows),
            "compute_ms": round(sum(r["compute_ms"] for r in rows), 6),
            "comm_ms": round(sum(r["comm_ms"] for r in rows), 6),
            "exposed_comm_ms": round(sum(r["exposed_comm_ms"]
                                         for r in rows), 6),
            "idle_ms": round(sum(r["idle_ms"] for r in rows), 6),
            "busy_ms": round(sum(r["busy_ms"] for r in rows), 6),
            "straggler_score": round(max(zs), 3) if zs else 0.0,
            "straggler_steps": sorted(r["step"] for r in stragglers
                                      if r["device"] == dev),
        }
    comm = sum(d["comm_ms"] for d in per_device.values())
    exposed = sum(d["exposed_comm_ms"] for d in per_device.values())
    totals = {
        "compute_ms": round(sum(d["compute_ms"]
                                for d in per_device.values()), 6),
        "comm_ms": round(comm, 6),
        "exposed_comm_ms": round(exposed, 6),
        "idle_ms": round(sum(d["idle_ms"] for d in per_device.values()), 6),
        # None (not 0.0) when nothing collective ran: a fraction from a
        # comm-free capture must not be mistaken for "fully hidden"
        "exposed_comm_fraction": (round(exposed / comm, 6) if comm > 0
                                  else None),
    }
    return {
        "kind": "device_timeline",
        "version": 1,
        "devices": sorted(lanes),
        "n_steps": len(steps),
        "steps": steps,
        "per_device": per_device,
        "totals": totals,
        "stragglers": stragglers,
        "dropped_events": int(getattr(events, "dropped_events", 0)),
    }


def straggler_rows(steps: List[dict], *,
                   z_threshold: float = STRAGGLER_Z,
                   min_slowdown: float = STRAGGLER_MIN_SLOWDOWN
                   ) -> List[dict]:
    """Per-step leave-one-out straggler detection: device ``d`` in step
    ``s`` is flagged when its busy time z-scores ``z_threshold`` away
    from the REST of the mesh (std floored at ``_Z_STD_FLOOR_FRAC x
    rest-mean``) AND is at least ``min_slowdown`` x the rest's mean.
    The fleet view feeds hosts through this same detector."""
    out = []
    for s in steps:
        devs = s["devices"]
        if len(devs) < 2:
            continue
        for dev, row in devs.items():
            rest = [r["busy_ms"] for d, r in devs.items() if d != dev]
            mean = sum(rest) / len(rest)
            var = sum((v - mean) ** 2 for v in rest) / len(rest)
            std = max(math.sqrt(var), _Z_STD_FLOOR_FRAC * mean, 1e-9)
            z = (row["busy_ms"] - mean) / std
            if z >= z_threshold and row["busy_ms"] >= mean * min_slowdown:
                out.append({
                    "step": s["step"], "device": dev,
                    "busy_ms": row["busy_ms"],
                    "mesh_mean_ms": round(mean, 6),
                    "mesh_std_ms": round(std, 6),
                    "z": round(z, 3),
                })
    return out


# ---------------------------------------------------------------------------
# registry export: gauges ride the batched flush, stragglers are events
# ---------------------------------------------------------------------------

def observe(decomp: dict, registry) -> None:
    """Export a decomposition through ``registry``: the mean
    per-device-step components as ``step.device_compute_ms`` /
    ``step.device_comm_ms`` / ``step.exposed_comm_ms`` /
    ``step.device_idle_ms`` gauges (plain floats: no device read), the
    overlap factor as ``step.exposed_comm_fraction``, and one
    ``timeline.straggler`` event per flagged row."""
    if registry is None or not getattr(registry, "enabled", False):
        return
    n = sum(d["steps"] for d in decomp["per_device"].values())
    if n:
        for gauge, key in (("step.device_compute_ms", "compute_ms"),
                           ("step.device_comm_ms", "comm_ms"),
                           ("step.exposed_comm_ms", "exposed_comm_ms"),
                           ("step.device_idle_ms", "idle_ms")):
            registry.gauge(gauge).set(decomp["totals"][key] / n)
    frac = decomp["totals"]["exposed_comm_fraction"]
    if frac is not None:
        registry.gauge("step.exposed_comm_fraction").set(frac)
    for row in decomp["stragglers"]:
        registry.event("timeline.straggler", **row)


# ---------------------------------------------------------------------------
# correlated host + device timeline
# ---------------------------------------------------------------------------

def mirror_offset(host_events: Sequence[dict],
                  device_events: Sequence[dict]
                  ) -> Optional[Tuple[float, int]]:
    """The host clock's offset onto the profiler's, from host spans a
    profiler session mirrored (every span of the port opens a
    ``record_function`` range of its name while a session records, so
    the capture holds a ``user_annotation`` row for each): per name, the
    host spans and the rows paired in order, the median gap over every
    pair.  Where one side holds more of a name (a capture window inside
    a longer run), the run of them paired is the one whose durations
    agree best.  Returns ``(offset_us, pairs)``, or None where no name
    has a pair."""
    host: Dict[str, List[dict]] = {}
    for e in host_events:
        if e.get("ph", "X") == "X" and e.get("dur") is not None \
                and e.get("cat") != _DEVICE_RANGE_CAT:
            host.setdefault(e.get("name"), []).append(e)
    rows: Dict[str, List[dict]] = {}
    for e in device_events:
        if e.get("cat") == "user_annotation" and e.get("name") in host:
            rows.setdefault(e["name"], []).append(e)
    gaps: List[float] = []
    for name, ds in rows.items():
        hs = sorted(host[name], key=lambda e: float(e["ts"]))
        ds = sorted(ds, key=lambda e: float(e["ts"]))
        short, long_ = (hs, ds) if len(hs) <= len(ds) else (ds, hs)
        n = len(short)

        def misfit(k):
            return sum(abs(float(a["dur"]) - float(b["dur"]))
                       for a, b in zip(short, long_[k:k + n]))
        k = min(range(len(long_) - n + 1), key=misfit)
        pairs = zip(short, long_[k:k + n]) if short is hs \
            else zip(long_[k:k + n], short)
        gaps.extend(float(d["ts"]) - float(h["ts"]) for h, d in pairs)
    if not gaps:
        return None
    return statistics.median(gaps), len(gaps)


def merge_host_device(host, device_events: Sequence[dict], *,
                      host_offset_us: Optional[float] = None) -> dict:
    """One Chrome/Perfetto document holding host Tracer spans AND the
    device lanes.  ``host`` is a :meth:`Tracer.export` doc (or its
    ``traceEvents`` list); ``device_events`` the parsed profiler events.
    The tracer's clock and the profiler's share no epoch, so host
    timestamps are rebased by ``host_offset_us``; by default by the
    spans the profiler mirrored (:func:`mirror_offset`), and only in a
    capture with no mirrored span by aligning the earliest host event
    with the earliest device event, a guess.  The document's
    ``alignment`` says which (``method``: ``given``, ``mirrored_spans``
    or ``first_event_guess``; ``offset_us``; ``pairs``).  Device lanes
    keep their pids; host lanes are remapped clear of them.

    Divergence from the JAX module: the mirrored-span alignment and the
    ``alignment`` key (the JAX package's host spans never reach its
    profiler, so it always guesses)."""
    if isinstance(host, dict):
        host_events = [e for e in host.get("traceEvents", [])
                       if e.get("ph") in ("X", "i", "C")]
    else:
        host_events = [dict(e) for e in host]
    dev_spans = [e for e in device_events if e.get("dur") is not None]
    alignment = {"method": "given", "offset_us": host_offset_us, "pairs": 0}
    if host_offset_us is None:
        mirrored = mirror_offset(host_events, device_events)
        if mirrored is not None:
            host_offset_us, pairs = mirrored
            alignment = {"method": "mirrored_spans",
                         "offset_us": host_offset_us, "pairs": pairs}
        else:
            h0 = min((e["ts"] for e in host_events), default=0.0)
            d0 = min((e["ts"] for e in dev_spans), default=0.0)
            host_offset_us = d0 - h0
            alignment = {"method": "first_event_guess",
                         "offset_us": host_offset_us, "pairs": 0}
    used_pids = {e.get("pid") for e in dev_spans}
    host_pid = 1
    while host_pid in used_pids:
        host_pid += 1
    out: List[dict] = [{"ph": "M", "name": "process_name", "pid": host_pid,
                        "args": {"name": "host:apex_tpu"}}]
    dev_pids: Dict[str, int] = {}
    for e in dev_spans:
        proc = str(e.get("process", e.get("pid")))
        pid = e.get("pid")
        if proc not in dev_pids:
            dev_pids[proc] = pid
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "args": {"name": proc}})
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": e.get("tid"),
                        "args": {"name": str(e.get("thread", ""))}})
        out.append({"ph": "X", "name": e["name"],
                    "cat": e.get("cat", "device"),
                    "ts": e["ts"], "dur": e["dur"], "pid": pid,
                    "tid": e.get("tid"), "args": e.get("args", {})})
    for e in host_events:
        if e.get("ph") == "M":
            continue
        if "ph" in e:
            ev = dict(e)
        else:
            ev = {"ph": "X", "name": e.get("name", "?"),
                  "dur": float(e.get("dur", 0.0)), "cat": "host",
                  "tid": e.get("tid"), "args": e.get("args", {})}
        ev["pid"] = host_pid
        ev["ts"] = float(e.get("ts", 0.0)) + host_offset_us
        out.append(ev)
    return {"displayTimeUnit": "ms", "traceEvents": out,
            "alignment": alignment}


# ---------------------------------------------------------------------------
# the port's kernels in a capture
# ---------------------------------------------------------------------------

def port_launches(events: Sequence[dict],
                  windows: Optional[List[Tuple[int, float, float]]] = None
                  ) -> Dict[int, Dict[str, int]]:
    """``{step: {launch name: kernel events}}``: the port's kernels in each
    step window of a Kineto capture, found by their CUDA function names
    (:func:`apex_tpu_torch.utils.build.launch_name`), a kernel counted in
    the window its start falls in."""
    from ..utils.build import launch_name
    if windows is None:
        windows = step_windows(events)
    out: Dict[int, Dict[str, int]] = {int(s): {} for s, _, _ in windows}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = launch_name(e["name"])
        if name is None:
            continue
        for s, t0, t1 in windows:
            if t0 <= e["ts"] < t1:
                row = out[int(s)]
                row[name] = row.get(name, 0) + 1
                break
    return out


# ---------------------------------------------------------------------------
# loading / rendering / CLI
# ---------------------------------------------------------------------------

def load_events(path: str):
    """Parsed events from a trace file or profiler log dir -- delegated to
    :func:`telemetry.trace.load_chrome`."""
    from . import trace as _trace
    return _trace.load_chrome(path)


def summarize(path: str, **kwargs) -> dict:
    """:func:`decompose` over whatever ``path`` holds."""
    return decompose(load_events(path), **kwargs)


def format_decomposition(decomp: dict, top_steps: int = 24) -> str:
    """The human form: per-step decomposition table (device means) and
    the per-device skew section."""
    devs = decomp["devices"]
    lines = [f"device timeline decomposition ({len(devs)} devices, "
             f"{decomp['n_steps']} steps)"]
    if decomp.get("dropped_events"):
        lines.append(f"  WARNING: {decomp['dropped_events']} trace events "
                     "dropped (truncated capture?)")
    head = (f"{'step':<6}{'dur ms':>10}{'compute':>10}{'comm':>10}"
            f"{'exposed':>10}{'idle':>10}{'skew':>9}")
    lines += [head, "-" * len(head)]
    for s in decomp["steps"][:top_steps]:
        n = max(len(s["devices"]), 1)

        def mean(key, _s=s, _n=n):
            return sum(d[key] for d in _s["devices"].values()) / _n

        lines.append(f"{s['step']:<6}{s['dur_ms']:>10.3f}"
                     f"{mean('compute_ms'):>10.3f}{mean('comm_ms'):>10.3f}"
                     f"{mean('exposed_comm_ms'):>10.3f}"
                     f"{mean('idle_ms'):>10.3f}{s['skew_ms']:>9.3f}")
    if decomp["n_steps"] > top_steps:
        lines.append(f"... {decomp['n_steps'] - top_steps} more steps")
    t = decomp["totals"]
    frac = t["exposed_comm_fraction"]
    lines.append(
        f"totals: compute {t['compute_ms']:.3f} ms  comm {t['comm_ms']:.3f}"
        f" ms  exposed {t['exposed_comm_ms']:.3f} ms"
        + (f" (fraction {frac:.3f})" if frac is not None
           else " (no collectives)")
        + f"  idle {t['idle_ms']:.3f} ms")
    lines.append("")
    lines.append("per-device skew:")
    dhead = (f"{'device':<32}{'steps':>6}{'busy ms':>11}{'exposed':>10}"
             f"{'idle':>9}{'z':>7}  straggler steps")
    lines += [dhead, "-" * len(dhead)]
    for dev in devs:
        d = decomp["per_device"][dev]
        name = dev if len(dev) <= 32 else "..." + dev[-29:]
        flagged = (",".join(str(s) for s in d["straggler_steps"])
                   if d["straggler_steps"] else "-")
        lines.append(f"{name:<32}{d['steps']:>6}{d['busy_ms']:>11.3f}"
                     f"{d['exposed_comm_ms']:>10.3f}{d['idle_ms']:>9.3f}"
                     f"{d['straggler_score']:>7.2f}  {flagged}")
    if decomp["stragglers"]:
        lines.append(f"{len(decomp['stragglers'])} timeline.straggler "
                     "row(s) flagged")
    return "\n".join(lines)


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry timeline <trace|profiler-dir>``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry timeline",
        description="Per-device step decomposition (compute / comm / "
                    "EXPOSED comm / idle ms, interval-exact) + straggler "
                    "skew from a torch.profiler log dir or any "
                    "chrome-trace file the trace loader accepts.")
    ap.add_argument("trace", help="profiler log dir or trace file "
                                  "(.json / .json.gz)")
    ap.add_argument("--host", default=None,
                    help="a Tracer.write export to merge into a "
                         "correlated host+device timeline")
    ap.add_argument("--out", default=None,
                    help="write the merged chrome timeline here "
                         "(requires --host)")
    ap.add_argument("--json", action="store_true",
                    help="print the decomposition as one JSON document")
    ap.add_argument("--z", type=float, default=STRAGGLER_Z,
                    help="straggler z-score threshold")
    ap.add_argument("--top", type=int, default=24, help="step rows shown")
    args = ap.parse_args(argv)

    events = load_events(args.trace)
    if args.host:
        merged_doc = merge_host_device(list(load_events(args.host)), events)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(merged_doc, f)
        from ..pyprof import parse as _parse
        events = _parse.events_from_chrome(merged_doc["traceEvents"])
    decomp = decompose(events, z_threshold=args.z)
    if not decomp["devices"]:
        print(f"no device lanes found in {args.trace}")
        return 1
    if args.json:
        print(json.dumps(decomp))
    else:
        print(format_decomposition(decomp, top_steps=args.top))
        if args.host and args.out:
            print(f"\nmerged timeline: {args.out}")
    return 0
