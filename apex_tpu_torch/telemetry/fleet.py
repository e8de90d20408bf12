"""Fleet view: N per-host run dirs merged into one ``FLEET.json``.

Counterpart of the JAX package's ``apex_tpu/telemetry/fleet.py``, with its
public names and the ``FLEET.json`` / ``FLEET_TRACE.json`` schema (the JAX
``fleet_violations`` accepts the port's documents).  Every run artifact
is per-process: one ``GOODPUT.json``, one ``SERVE.json``, one JSONL gauge
stream, one profiler capture, each describing one host's run dir.  This
module merges N of them, host-count-agnostic.  Each host dir may hold ANY
subset of the artifacts (a host that died early has a torn JSONL tail and
no ledgers; a serve host has no goodput ledger) and the merge degrades per
host instead of failing the fleet.

What the merged doc carries (``fleet_violations`` writer-validates):

  * **fleet goodput** -- the exact interval union of the hosts'
    wall-clock windows (``wall_union_ms``; overlapping hosts are not
    double-counted) next to the per-class sums over ``wall_sum_ms``.
    Each host's classes must still partition THAT host's wall exactly
    (re-asserted via ``goodput_violations``), and the fleet classes sum
    to the summed wall to the same tolerance.
  * **cross-host skew** -- per shared step, the spread of the hosts'
    flush timestamps (max - min, ms).
  * **stragglers** -- leave-one-out z-scores over per-host step time,
    through :func:`.timeline.straggler_rows` with hosts standing in as
    the "devices" (the naming logic lives there, once).
  * **control / flight correlation** -- every host's ``CONTROL.json``
    decisions and flight dumps in one list, each row carrying which host
    acted/dumped and at which window/step.  The port has no run
    controller yet: the guarded ``control`` import reads None.
  * **merged timeline** -- one Chrome/Perfetto doc with one pid lane
    group per host, every host rebased onto the shared fleet epoch
    (:func:`.timeline.merge_host_device` generalized N-way).

A 1-host fleet is the degenerate case and agrees with the single-run
tooling: its per-host summary IS ``report.summarize`` over the same
records.  File-based, no device read.
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from . import goodput as _goodput

__all__ = [
    "ARTIFACT_NAME", "TIMELINE_NAME", "GOODPUT_CLASSES",
    "load_host", "build_fleet", "merge_host_timelines",
    "fleet_violations", "write_fleet", "format_fleet", "load_artifact",
    "cli",
]

ARTIFACT_NAME = "FLEET.json"
#: the merged Chrome doc written next to the artifact by ``--out``
TIMELINE_NAME = "FLEET_TRACE.json"

#: the goodput partition
GOODPUT_CLASSES = tuple(_goodput.CLASSES)

_PARTITION_TOL_MS = 1e-3

_is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
_is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)
_is_str = lambda v: isinstance(v, str) and bool(v)


def _ts() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _parse_ts(ts: Any) -> Optional[float]:
    """Registry ``_ts`` string -> epoch seconds (None on any other
    shape — a reader must tolerate foreign timestamps)."""
    if not isinstance(ts, str):
        return None
    try:
        import calendar
        return float(calendar.timegm(
            time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")))
    except ValueError:
        return None


def _union_ms(windows: List[Tuple[float, float]]) -> float:
    """Total covered ms of a set of [start, end] epoch-second windows
    (the exact interval union — overlap counted once)."""
    ivals = sorted((s, e) for s, e in windows if e > s)
    total = 0.0
    cur_s = cur_e = None
    for s, e in ivals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e3


# ---------------------------------------------------------------------------
# per-host loading (any subset of artifacts; torn tails tolerated)
# ---------------------------------------------------------------------------

def _host_records(path: str) -> List[dict]:
    from .report import load_records
    records: List[dict] = []
    for f in sorted(glob.glob(os.path.join(path, "*.jsonl"))):
        try:
            records.extend(load_records(f))
        except OSError:
            continue
    return records


def _host_traces(path: str) -> List[dict]:
    from . import trace as _trace
    events: List[dict] = []
    seen = set()
    for pat in ("*.trace.json", "trace*.json", "TRACE*.json"):
        for f in sorted(glob.glob(os.path.join(path, pat))):
            if f in seen:
                continue
            seen.add(f)
            try:
                events.extend(_trace.load_chrome(f))
            except (OSError, ValueError):
                continue   # a torn capture degrades, never fails
    return events


def _host_flights(path: str, host: str) -> List[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(path, "flight-*.json"))):
        base = os.path.basename(f)
        parts = base[len("flight-"):-len(".json")].split("-")
        row = {"host": host, "file": base,
               "reason": parts[0] if parts else "unknown"}
        try:
            with open(f) as fh:
                doc = json.load(fh)
            if isinstance(doc, dict):
                if _is_num(doc.get("step")):
                    row["step"] = int(doc["step"])
                if isinstance(doc.get("ts"), str):
                    row["ts"] = doc["ts"]
                if isinstance(doc.get("reason"), str):
                    row["reason"] = doc["reason"]
        except (OSError, ValueError):
            row["torn"] = True   # the dump itself was interrupted
        out.append(row)
    return out


def load_host(path: str, name: Optional[str] = None) -> dict:
    """Load one host's run dir: every artifact it has, None for every
    artifact it lacks.  Never raises on a partial/degraded dir."""
    from .report import summarize
    host = name or os.path.basename(os.path.normpath(path)) or path
    records = _host_records(path)
    try:
        good = _goodput.load_artifact(path)
    except ValueError:
        good = None
    control = serve = None
    try:
        from ..control import ledger as _ctl_ledger
        control = _ctl_ledger.load_artifact(path)
    except (ImportError, ValueError, OSError):
        control = None
    try:
        from . import serve_ledger as _serve_ledger
        serve = _serve_ledger.load_artifact(path)
    except (ImportError, ValueError, OSError):
        serve = None
    # the wall-clock window this host occupied (epoch seconds): the
    # artifact's write timestamp minus its wall, else the JSONL span
    window = None
    if good is not None and good.get("source") != "jsonl":
        end = _parse_ts(good.get("ts"))
        if end is not None and _is_num(good.get("wall_ms")):
            window = (end - float(good["wall_ms"]) / 1e3, end)
    if window is None and records:
        stamps = [t for t in (_parse_ts(r.get("ts")) for r in records)
                  if t is not None]
        if stamps:
            window = (min(stamps), max(stamps))
    return {
        "name": host, "dir": path, "records": records,
        "goodput": good, "control": control, "serve": serve,
        "flights": _host_flights(path, host),
        "trace_events": _host_traces(path),
        "window": window,
        "summary": summarize(records) if records else None,
    }


# ---------------------------------------------------------------------------
# cross-host signals
# ---------------------------------------------------------------------------

def _step_samples(records: List[dict]) -> Dict[int, Tuple[float, Optional[float]]]:
    """step -> (busy_ms, flush epoch) from a host's ``step_time_ms``
    stream (the per-flush histogram records)."""
    out: Dict[int, Tuple[float, Optional[float]]] = {}
    for r in records:
        if r.get("kind") != "metric" or r.get("name") != "step_time_ms":
            continue
        stats = r.get("stats")
        if not (isinstance(stats, dict) and _is_num(stats.get("mean"))):
            continue
        out[int(r.get("step", 0))] = (float(stats["mean"]),
                                      _parse_ts(r.get("ts")))
    return out


def _skew_and_stragglers(hosts: List[dict], *, z_threshold: float,
                         min_slowdown: float) -> Tuple[dict, dict]:
    per_host = {h["name"]: _step_samples(h["records"]) for h in hosts}
    shared: Dict[int, Dict[str, Tuple[float, Optional[float]]]] = {}
    for host, samples in per_host.items():
        for step, pair in samples.items():
            shared.setdefault(step, {})[host] = pair
    skews: List[float] = []
    rows: List[dict] = []
    for step in sorted(shared):
        by_host = shared[step]
        if len(by_host) < 2:
            continue
        stamps = [t for _, t in by_host.values() if t is not None]
        if len(stamps) >= 2:
            skews.append((max(stamps) - min(stamps)) * 1e3)
        rows.append({"step": step,
                     "devices": {h: {"busy_ms": busy}
                                 for h, (busy, _) in by_host.items()}})
    skew = {"steps_compared": len(rows),
            "max_skew_ms": round(max(skews), 3) if skews else 0.0,
            "mean_skew_ms": round(sum(skews) / len(skews), 3)
            if skews else 0.0}
    flagged: List[dict] = []
    if rows:
        # hosts stand in as the "devices": the leave-one-out estimator
        # (and its std floor + min_slowdown gate) lives in timeline,
        # once — the fleet must not fork the naming logic
        from . import timeline as _timeline
        flagged = _timeline.straggler_rows(
            rows, z_threshold=z_threshold, min_slowdown=min_slowdown)
    counts: Dict[str, int] = {}
    for f in flagged:
        counts[str(f["device"])] = counts.get(str(f["device"]), 0) + 1
    named = max(counts.items(), key=lambda kv: kv[1])[0] if counts else None
    stragglers = {
        "rows": [{"step": f["step"], "host": str(f["device"]),
                  "busy_ms": round(float(f["busy_ms"]), 3),
                  "fleet_mean_ms": round(float(f["mesh_mean_ms"]), 3),
                  "z": round(float(f["z"]), 3)} for f in flagged],
        "hosts": counts, "named": named,
        "max_z": round(max((float(f["z"]) for f in flagged), default=0.0),
                       3),
    }
    return skew, stragglers


def _loss_gauges(records: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in records:
        if (r.get("kind") == "metric" and r.get("type") == "gauge"
                and isinstance(r.get("name"), str)
                and r["name"].startswith("loss.")
                and _is_num(r.get("value"))):
            out[r["name"]] = float(r["value"])
    return out


# ---------------------------------------------------------------------------
# N-way timeline merge (merge_host_device generalized)
# ---------------------------------------------------------------------------

def merge_host_timelines(host_events: Dict[str, List[dict]],
                         host_offsets_us: Optional[Dict[str, float]] = None
                         ) -> dict:
    """One Chrome doc from N hosts' event lists: one pid lane group per
    host, every host rebased onto the shared fleet epoch.  This is
    :func:`timeline.merge_host_device` generalized N-way — the 2-lane
    merge aligns a host stream onto a device stream's clock; here every
    host's earliest event lands at its ``host_offsets_us`` offset from
    the fleet epoch (0 when no offset is known — side-by-side lanes)."""
    merged: List[dict] = []
    next_pid = 1
    for i, host in enumerate(sorted(host_events)):
        raw = [e for e in host_events[host] if isinstance(e, dict)]
        events = [e for e in raw if "ph" in e]
        # ``load_chrome``/``pyprof.parse`` output strips ``ph`` — those
        # are complete spans by construction, so readmit them as "X"
        # rows (a fleet built from real capture files must merge, not
        # just one fed raw Chrome docs)
        spans = [dict(e, ph="X") for e in raw
                 if "ph" not in e and _is_num(e.get("ts"))
                 and _is_num(e.get("dur"))]
        rows = [e for e in events if e.get("ph") != "M"] + spans
        names = {e.get("pid", 0): (e.get("args") or {}).get("name")
                 for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        for e in spans:   # parse-shape lane names ride in "process"
            pid = e.get("pid", 0)
            proc = e.get("process")
            if proc and pid not in names and proc != str(pid):
                names[pid] = proc
        t0 = min((float(e["ts"]) for e in rows if _is_num(e.get("ts"))),
                 default=0.0)
        shift = float((host_offsets_us or {}).get(host, 0.0)) - t0
        pid_map: Dict[Any, int] = {}
        for e in rows:
            pid = e.get("pid", 0)
            if pid not in pid_map:
                pid_map[pid] = next_pid
                next_pid += 1
                lane = names.get(pid)
                merged.append({"ph": "M", "name": "process_name",
                               "pid": pid_map[pid],
                               "args": {"name": f"{host}:{lane}" if lane
                                        else f"{host}:pid{pid}"}})
            row = dict(e)
            row["pid"] = pid_map[pid]
            if _is_num(row.get("ts")):
                row["ts"] = float(row["ts"]) + shift
            merged.append(row)
    return {"displayTimeUnit": "ms", "traceEvents": merged}


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def build_fleet(dirs: List[str], *, host_names: Optional[List[str]] = None,
                z_threshold: float = 3.0, min_slowdown: float = 1.2
                ) -> Tuple[dict, dict]:
    """Merge N per-host run dirs.  Returns ``(doc, timeline)`` — the
    ``FLEET.json`` doc and the merged Chrome doc (empty traceEvents
    when no host had a capture)."""
    if not dirs:
        raise ValueError("fleet merge needs at least one run dir")
    names = list(host_names) if host_names else []
    hosts: List[dict] = []
    used = set()
    for i, d in enumerate(dirs):
        name = names[i] if i < len(names) else None
        h = load_host(d, name)
        base = h["name"]
        n = 1
        while h["name"] in used:   # two dirs with one basename stay apart
            n += 1
            h["name"] = f"{base}#{n}"
        used.add(h["name"])
        hosts.append(h)

    per_host: Dict[str, dict] = {}
    class_ms = {c: 0.0 for c in GOODPUT_CLASSES}
    wall_sum = 0.0
    windows: List[Tuple[float, float]] = []
    steps = replayed = 0
    for h in hosts:
        good = h["goodput"]
        entry: Dict[str, Any] = {
            "dir": h["dir"],
            "records": len(h["records"]),
            "flight_dumps": len(h["flights"]),
            "summary": h["summary"],
            "serve": h["serve"],
            "goodput": good,
            "goodput_source": None,
            "partition_ok": None,
            "control_decisions": (len(h["control"]["decisions"])
                                  if h["control"] else None),
            "loss": _loss_gauges(h["records"]),
        }
        if h["window"] is not None:
            s, e = h["window"]
            entry["window"] = {"start_epoch": round(s, 3),
                               "end_epoch": round(e, 3),
                               "wall_ms": round((e - s) * 1e3, 3)}
        else:
            entry["window"] = None
        if good is not None:
            src = "jsonl" if good.get("source") == "jsonl" else "artifact"
            entry["goodput_source"] = src
            if src == "artifact":
                # the load-bearing assertion: this host's classes must
                # still partition ITS wall exactly — a fleet view that
                # tolerated a torn partition would launder the books
                bad = _goodput.goodput_violations(good)
                entry["partition_ok"] = not bad
                if bad:
                    raise ValueError(
                        f"host {h['name']!r}: goodput artifact fails its "
                        "own partition: " + "; ".join(bad[:4]))
            if _is_num(good.get("wall_ms")):
                wall_sum += float(good["wall_ms"])
                # the union covers exactly the windows whose walls are
                # in the sum — a JSONL-only host (no goodput wall)
                # must not widen the union past the books it kept
                if h["window"] is not None:
                    windows.append(h["window"])
            for c in GOODPUT_CLASSES:
                row = (good.get("classes") or {}).get(c)
                if isinstance(row, dict) and _is_num(row.get("ms")):
                    class_ms[c] += float(row["ms"])
            steps += int(good.get("steps", 0) or 0)
            replayed += int(good.get("replayed_steps", 0) or 0)
        per_host[h["name"]] = entry

    wall_union = _union_ms(windows)
    fleet_good = {
        "wall_sum_ms": round(wall_sum, 6),
        "wall_union_ms": round(wall_union, 6),
        "overlap_ms": round(max(wall_sum - wall_union, 0.0), 6)
        if windows else 0.0,
        "classes": {c: {"ms": round(class_ms[c], 6),
                        "fraction": round(class_ms[c] / wall_sum, 9)
                        if wall_sum > 0 else 0.0}
                    for c in GOODPUT_CLASSES},
        "goodput_fraction": round(class_ms["productive"] / wall_sum, 9)
        if wall_sum > 0 else 0.0,
        "steps": steps, "replayed_steps": replayed,
    }

    skew, stragglers = _skew_and_stragglers(
        hosts, z_threshold=z_threshold, min_slowdown=min_slowdown)

    decisions: List[dict] = []
    fired = suppressed = failed = 0
    for h in hosts:
        ctl = h["control"]
        if not ctl:
            continue
        fired += int(ctl.get("actions_fired", 0) or 0)
        suppressed += (int(ctl.get("suppressed_cooldown", 0) or 0)
                       + int(ctl.get("suppressed_max_actions", 0) or 0))
        failed += int(ctl.get("failed_reverted", 0) or 0)
        for d in ctl.get("decisions", ()):
            if isinstance(d, dict):
                decisions.append({"host": h["name"], **d})
    decisions.sort(key=lambda d: (d.get("window", 0), d.get("step", 0)))

    flights: List[dict] = []
    for h in hosts:
        flights.extend(h["flights"])
    flights.sort(key=lambda f: (f.get("ts") or "", f.get("file", "")))

    served = sum(int((h["serve"] or {}).get("requests", {})
                     .get("served", 0) or 0) for h in hosts)
    shed = sum(int((h["serve"] or {}).get("requests", {})
                   .get("shed", 0) or 0) for h in hosts)
    any_serve = any(h["serve"] for h in hosts)

    doc = {
        "kind": "fleet", "version": 1, "ts": _ts(),
        "hosts": [h["name"] for h in hosts],
        "n_hosts": len(hosts),
        "goodput": fleet_good,
        "skew": skew,
        "stragglers": stragglers,
        "control": {"actions_fired": fired, "suppressed": suppressed,
                    "failed_reverted": failed, "decisions": decisions},
        "flights": flights,
        "serve": ({"requests_served": served, "requests_shed": shed}
                  if any_serve else None),
        "per_host": {name: {k: v for k, v in entry.items()
                            if k != "summary" or v is not None}
                     for name, entry in per_host.items()},
    }
    bad = fleet_violations(doc)
    if bad:   # writer-validates: a fleet doc that fails its own schema
        raise ValueError("fleet doc fails its schema: " + "; ".join(bad[:4]))

    epoch0 = min((s for s, _ in windows), default=None)
    offsets = {}
    for h in hosts:
        if h["window"] is not None and epoch0 is not None:
            offsets[h["name"]] = (h["window"][0] - epoch0) * 1e6
    timeline = merge_host_timelines(
        {h["name"]: h["trace_events"] for h in hosts if h["trace_events"]},
        offsets)
    return doc, timeline


# ---------------------------------------------------------------------------
# schema (writer-validates)
# ---------------------------------------------------------------------------

def fleet_violations(doc: Any) -> List[str]:
    """Schema complaints for a fleet doc (empty = valid).  Load-bearing
    checks: every artifact-sourced per-host goodput doc's classes
    partition that host's wall EXACTLY, the fleet classes sum to the
    summed wall to the same tolerance, the union never exceeds the sum,
    and every control decision / flight row names its host."""
    if not isinstance(doc, dict):
        return [f"doc is not an object: {type(doc).__name__}"]
    out = []
    if doc.get("kind") != "fleet":
        out.append(f"bad kind {doc.get('kind')!r}")
    if doc.get("version") != 1:
        out.append(f"unknown version {doc.get('version')!r}")
    hosts = doc.get("hosts")
    per_host = doc.get("per_host")
    if not (isinstance(hosts, list) and hosts
            and all(_is_str(h) for h in hosts)):
        out.append("hosts must be a non-empty list of names")
        hosts = []
    if doc.get("n_hosts") != len(hosts):
        out.append(f"n_hosts {doc.get('n_hosts')!r} != {len(hosts)}")
    if not (isinstance(per_host, dict) and set(per_host) == set(hosts)):
        out.append("per_host keys must match hosts")
        per_host = {}
    g = doc.get("goodput")
    if not isinstance(g, dict):
        return out + ["missing goodput block"]
    wall_sum = g.get("wall_sum_ms")
    wall_union = g.get("wall_union_ms")
    if not (_is_num(wall_sum) and wall_sum >= 0):
        out.append(f"bad wall_sum_ms {wall_sum!r}")
        wall_sum = 0.0
    if not (_is_num(wall_union) and wall_union >= 0):
        out.append(f"bad wall_union_ms {wall_union!r}")
    elif wall_union > wall_sum + max(_PARTITION_TOL_MS, 1e-6 * wall_sum):
        out.append(f"wall_union_ms {wall_union} exceeds wall_sum_ms "
                   f"{wall_sum} — overlap counted twice")
    classes = g.get("classes")
    if not (isinstance(classes, dict)
            and set(classes) == set(GOODPUT_CLASSES)):
        out.append("goodput.classes keys off the goodput partition")
    else:
        # per-host partitions are each exact to _PARTITION_TOL_MS; the
        # fleet sum inherits up to one tolerance per host
        tol = max(_PARTITION_TOL_MS * max(len(hosts), 1),
                  1e-6 * max(wall_sum, 1.0))
        total = 0.0
        for c, row in classes.items():
            if not (isinstance(row, dict) and _is_num(row.get("ms"))
                    and _is_num(row.get("fraction"))):
                out.append(f"goodput.classes.{c}: needs ms + fraction")
                continue
            if row["ms"] < -tol:
                out.append(f"goodput.classes.{c}: negative ms {row['ms']}")
            if not -1e-9 <= row["fraction"] <= 1.0 + 1e-9:
                out.append(f"goodput.classes.{c}: fraction "
                           f"{row['fraction']} outside [0, 1]")
            total += float(row["ms"])
        if wall_sum > 0 and abs(total - wall_sum) > tol:
            out.append(f"fleet classes sum {total} != wall_sum_ms "
                       f"{wall_sum} (tol {tol})")
        gf = g.get("goodput_fraction")
        prod = (classes.get("productive") or {}).get("fraction")
        if not _is_num(gf) or (_is_num(prod)
                               and abs(gf - prod) > 1e-9):
            out.append(f"goodput_fraction {gf!r} != productive fraction "
                       f"{prod!r}")
    # per-host: the exact-partition assertion, re-run at read time
    for name, entry in (per_host or {}).items():
        if not isinstance(entry, dict):
            out.append(f"per_host.{name}: not an object")
            continue
        good = entry.get("goodput")
        if good is None:
            continue
        if entry.get("goodput_source") == "artifact":
            if entry.get("partition_ok") is not True:
                out.append(f"per_host.{name}: artifact goodput without "
                           "partition_ok")
            w = good.get("wall_ms")
            cls = good.get("classes")
            if _is_num(w) and isinstance(cls, dict):
                host_total = sum(float(r.get("ms", 0.0)) for r in
                                 cls.values() if isinstance(r, dict))
                tol = max(_PARTITION_TOL_MS, 1e-6 * max(float(w), 1.0))
                if abs(host_total - float(w)) > tol:
                    out.append(f"per_host.{name}: classes sum "
                               f"{host_total} != wall {w} — the host "
                               "partition is torn")
            for v in _goodput.goodput_violations(good)[:2]:
                out.append(f"per_host.{name}: {v}")
    skew = doc.get("skew")
    if not (isinstance(skew, dict) and _is_int(skew.get("steps_compared"))
            and _is_num(skew.get("max_skew_ms"))
            and skew["max_skew_ms"] >= 0):
        out.append("skew must carry steps_compared + max_skew_ms >= 0")
    st = doc.get("stragglers")
    if not isinstance(st, dict):
        out.append("missing stragglers block")
    else:
        for r in st.get("rows", ()):
            if not (isinstance(r, dict) and _is_str(r.get("host"))
                    and _is_num(r.get("z")) and _is_num(r.get("busy_ms"))):
                out.append(f"stragglers row off-schema: {r!r}")
                break
        if st.get("named") is not None and not _is_str(st.get("named")):
            out.append(f"bad stragglers.named {st.get('named')!r}")
    ctl = doc.get("control")
    if not (isinstance(ctl, dict) and _is_int(ctl.get("actions_fired"))):
        out.append("control must carry int actions_fired")
    else:
        for d in ctl.get("decisions", ()):
            if not (isinstance(d, dict) and _is_str(d.get("host"))
                    and _is_str(d.get("outcome"))):
                out.append(f"control decision without host/outcome: {d!r}")
                break
    for f in doc.get("flights", ()):
        if not (isinstance(f, dict) and _is_str(f.get("host"))
                and _is_str(f.get("reason"))):
            out.append(f"flight row without host/reason: {f!r}")
            break
    return out


# ---------------------------------------------------------------------------
# artifact io / rendering / CLI
# ---------------------------------------------------------------------------

def write_fleet(doc: dict, path: str,
                timeline: Optional[dict] = None) -> str:
    """Atomic-replace write of a (re-validated) fleet doc; ``timeline``
    lands next to it as ``FLEET_TRACE.json`` when it has events."""
    bad = fleet_violations(doc)
    if bad:
        raise ValueError("fleet doc fails its schema: " + "; ".join(bad[:4]))
    if os.path.isdir(path):
        path = os.path.join(path, ARTIFACT_NAME)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    if timeline and timeline.get("traceEvents"):
        tl_path = os.path.join(os.path.dirname(path) or ".", TIMELINE_NAME)
        tmp = f"{tl_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(timeline, f)
        os.replace(tmp, tl_path)
    return path


def load_artifact(path: str) -> dict:
    """Read a ``FLEET.json`` (or a run/out directory containing one)
    and audit it — an artifact failing its own schema raises."""
    if os.path.isdir(path):
        cand = os.path.join(path, ARTIFACT_NAME)
        if not os.path.exists(cand):
            raise ValueError(f"{path}: no {ARTIFACT_NAME} in directory")
        path = cand
    with open(path) as f:
        doc = json.load(f)
    bad = fleet_violations(doc)
    if bad:
        raise ValueError(f"{path}: invalid fleet doc: " + "; ".join(bad[:4]))
    return doc


def format_fleet(doc: dict) -> str:
    g = doc.get("goodput") or {}
    lines = [
        f"fleet view  ({doc.get('n_hosts', 0)} hosts, "
        f"wall union {g.get('wall_union_ms', 0.0):.1f} ms, "
        f"goodput {g.get('goodput_fraction', 0.0):.4f})",
        f"  {'host':<18}{'wall ms':>12}{'goodput':>10}"
        f"{'steps':>8}{'ctl':>6}{'dumps':>7}",
    ]
    per_host = doc.get("per_host") or {}
    for name in doc.get("hosts", ()):
        e = per_host.get(name) or {}
        good = e.get("goodput") or {}
        wall = good.get("wall_ms")
        frac = good.get("goodput_fraction")
        summ = e.get("summary") or {}
        lines.append(
            f"  {name:<18}"
            + (f"{wall:>12.1f}" if _is_num(wall) else f"{'-':>12}")
            + (f"{frac:>10.4f}" if _is_num(frac) else f"{'-':>10}")
            + f"{summ.get('steps', good.get('steps', 0)) or 0:>8}"
            + f"{e.get('control_decisions') if e.get('control_decisions') is not None else '-':>6}"
            + f"{e.get('flight_dumps', 0):>7}")
    skew = doc.get("skew") or {}
    lines.append(f"  skew: {skew.get('steps_compared', 0)} shared steps, "
                 f"max {skew.get('max_skew_ms', 0.0):.1f} ms")
    st = doc.get("stragglers") or {}
    if st.get("named"):
        lines.append(f"  straggler: {st['named']} "
                     f"(max z {st.get('max_z', 0.0):.1f}, "
                     f"{len(st.get('rows', ()))} flagged steps)")
    else:
        lines.append("  straggler: none flagged")
    ctl = doc.get("control") or {}
    lines.append(f"  control: {ctl.get('actions_fired', 0)} acted  "
                 f"{ctl.get('suppressed', 0)} suppressed  "
                 f"{ctl.get('failed_reverted', 0)} failed")
    for d in (ctl.get("decisions") or ())[:8]:
        lines.append(f"    [{d.get('host')}] w{d.get('window')} "
                     f"step {d.get('step')}: {d.get('policy')} -> "
                     f"{d.get('action')} ({d.get('outcome')})")
    if doc.get("flights"):
        lines.append(f"  flight dumps: {len(doc['flights'])}  ("
                     + ", ".join(f"{f['host']}:{f['reason']}"
                                 for f in doc["flights"][:6]) + ")")
    if doc.get("serve"):
        s = doc["serve"]
        lines.append(f"  serve: {s.get('requests_served', 0)} served  "
                     f"{s.get('requests_shed', 0)} shed")
    return "\n".join(lines)


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry fleet <dir> [dir...]``: merge N
    per-host run dirs and render the fleet table.  ``--json`` prints
    the doc, ``--out`` writes ``FLEET.json`` + the merged timeline.
    A single FLEET.json (or a dir holding one) renders without
    re-merging.  Exit 0 on a schema-valid fleet, 1 on bad input."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry fleet",
        description="merge per-host run dirs into one fleet view")
    ap.add_argument("dirs", nargs="+",
                    help="per-host run dirs (or one FLEET.json)")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated host names (default: basenames)")
    ap.add_argument("--json", action="store_true",
                    help="print the fleet doc instead of the table")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help=f"write {ARTIFACT_NAME} + {TIMELINE_NAME} here")
    ap.add_argument("--z-threshold", type=float, default=3.0)
    ap.add_argument("--min-slowdown", type=float, default=1.2)
    args = ap.parse_args(argv)
    try:
        if (len(args.dirs) == 1 and not args.out
                and (os.path.isfile(args.dirs[0])
                     or os.path.exists(os.path.join(args.dirs[0],
                                                    ARTIFACT_NAME)))):
            doc, timeline = load_artifact(args.dirs[0]), None
        else:
            names = (args.hosts.split(",") if args.hosts else None)
            doc, timeline = build_fleet(
                args.dirs, host_names=names,
                z_threshold=args.z_threshold,
                min_slowdown=args.min_slowdown)
    except (ValueError, OSError) as err:
        print(f"error: {err}")
        return 1
    if args.out:
        path = write_fleet(doc, args.out, timeline)
        print(f"wrote {path}")
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(format_fleet(doc))
    return 0
