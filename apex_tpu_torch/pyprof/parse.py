"""``pyprof.parse``: turn a captured profiler trace into per-op records.

Counterpart of the JAX package's ``apex_tpu/pyprof/parse.py``.  The capture
is a ``torch.profiler`` (Kineto) Chrome trace, written by
:func:`apex_tpu_torch.pyprof.trace` as ``*.pt.trace.json`` under its log
dir.  Its complete spans (``ph == "X"``) carry a Kineto category in
``cat``: host spans are ``cpu_op`` (aten ops), ``user_annotation``
(``record_function`` ranges), ``python_function`` and ``cuda_runtime``;
device spans are ``kernel``, ``gpu_memcpy``, ``gpu_memset`` and
``gpu_user_annotation`` (a host range mirrored onto the stream it
launched on).  This module parses the file and aggregates per-op *self
time* (duration minus time attributed to nested child spans):

    python -m apex_tpu_torch.pyprof.parse <log_dir> --top 20

or programmatically::

    from apex_tpu_torch.pyprof import parse
    events = parse.load("<log_dir>")
    table  = parse.op_table(events)
    print(parse.format_table(table))

Python frames (``cat`` ``python_function``, or a thread named ``python``)
are left out of the table unless ``include_python=True``.

Divergence from the JAX module: each parsed event also keeps the raw
record's ``cat`` where it has one (the JAX shape has no such key; a trace
without categories parses to exactly the JAX shape).  :mod:`..telemetry
.timeline` reads it to tell device work from host work.
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Any

# Runtime bookkeeping spans that would pollute an op table (not compute).
_NOISE_PREFIXES = (
    "ThreadpoolListener", "ThunkExecutor", "end: ", "Thread ",
    "process_", "thread_",
)

_TRACE_SUFFIXES = (".json", ".json.gz")


def _latest_trace_file(logdir: str) -> str:
    """Newest Chrome trace (``*trace.json`` or ``*trace.json.gz``) under
    ``logdir``, searched recursively."""
    found = []
    for root, _, files in os.walk(logdir):
        for f in files:
            if f.endswith(_TRACE_SUFFIXES) and "trace" in f:
                p = os.path.join(root, f)
                found.append((os.path.getmtime(p), p))
    if not found:
        raise FileNotFoundError(
            f"no *trace.json[.gz] under {logdir!r}: capture one with "
            "apex_tpu_torch.pyprof.trace(logdir)")
    return max(found)[1]


class EventList(list):
    """Parsed-event list + the ``dropped_events`` count: complete events
    a truncated capture left without ``ts``/``dur``.  Loss is counted,
    never silent."""

    dropped_events: int = 0


def events_from_chrome(raw: list) -> EventList:
    """Complete-span ("X") events from a raw Chrome traceEvents list,
    each annotated with its process/thread display names (from the "M"
    metadata events) and, where the record has one, its ``cat``.  Shared
    by this module's loader and ``telemetry.trace.load_chrome``.  "X"
    records missing ``ts`` or ``dur`` are dropped AND counted into the
    returned list's ``dropped_events``."""
    pname: dict[Any, str] = {}
    tname: dict[tuple, str] = {}
    for e in raw:
        if isinstance(e, dict) and e.get("ph") == "M":
            if e.get("name") == "process_name":
                pname[e.get("pid")] = e["args"]["name"]
            elif e.get("name") == "thread_name":
                tname[(e.get("pid"), e.get("tid"))] = e["args"]["name"]
    out = EventList()
    for e in raw:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        if e.get("ts") is None or e.get("dur") is None:
            out.dropped_events += 1
            continue
        ev = {
            "name": e.get("name", "?"),
            "ts": float(e["ts"]),
            "dur": float(e["dur"]),
            "pid": e.get("pid"),
            "tid": e.get("tid"),
            "process": pname.get(e.get("pid"), str(e.get("pid"))),
            "thread": tname.get((e.get("pid"), e.get("tid")),
                                str(e.get("tid"))),
            "args": e.get("args", {}),
        }
        if "cat" in e:
            ev["cat"] = e["cat"]
        out.append(ev)
    return out


def load(logdir: str) -> EventList:
    """Read the newest trace in ``logdir`` (or the file ``logdir`` names,
    plain or gzip); returns complete-span events (an :class:`EventList`
    carrying the ``dropped_events`` count)."""
    path = logdir if os.path.isfile(logdir) else _latest_trace_file(logdir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    raw = data.get("traceEvents", []) if isinstance(data, dict) else data
    return events_from_chrome(raw)


def _self_times(events: list[dict]) -> None:
    """Attribute self time in place: ``self_us = dur - sum(child durs)``.

    Spans within one (pid, tid) timeline nest by time containment (the
    Chrome trace contract); a sweep with an open-span stack attributes
    each span's duration to itself minus its direct children.  The debit
    is clamped at zero: equal-bound twin spans come in either order.
    """
    by_thread: dict[tuple, list[dict]] = {}
    for e in events:
        by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    for evs in by_thread.values():
        # parents first: earlier start, then longer duration
        evs.sort(key=lambda e: (e["ts"], -e["dur"], e.get("name", "")))
        stack: list[dict] = []
        for e in evs:
            e["self_us"] = e["dur"]
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack:
                p = stack[-1]
                if e["ts"] + e["dur"] <= p["ts"] + p["dur"]:
                    p["self_us"] -= min(e["dur"], max(p["self_us"], 0.0))
                # else: partial overlap (malformed trace) -- keep e on the
                # stack for pop bookkeeping but don't debit p
            stack.append(e)


def _is_python(e: dict) -> bool:
    return e["thread"] == "python" or e.get("cat") == "python_function"


def op_table(events: list[dict], include_python: bool = False,
             include_noise: bool = False) -> list[dict]:
    """Aggregate per-op-name records: count / total / self / avg / pct.

    One row per op or kernel name with summed durations; ``pct`` is the
    share of summed self time.
    """
    _self_times(events)
    rows: dict[str, dict] = {}
    for e in events:
        if not include_python and _is_python(e):
            continue
        if not include_noise and e["name"].startswith(_NOISE_PREFIXES):
            continue
        r = rows.setdefault(e["name"], {
            "name": e["name"], "count": 0, "total_us": 0.0, "self_us": 0.0})
        r["count"] += 1
        r["total_us"] += e["dur"]
        r["self_us"] += max(e["self_us"], 0.0)
    table = sorted(rows.values(), key=lambda r: -r["self_us"])
    total_self = sum(r["self_us"] for r in table) or 1.0
    for r in table:
        r["avg_us"] = r["total_us"] / r["count"]
        r["pct"] = 100.0 * r["self_us"] / total_self
    return table


def format_table(table: list[dict], top: int = 20) -> str:
    head = f"{'op':<48} {'count':>6} {'self ms':>9} {'avg us':>9} {'%':>6}"
    lines = [head, "-" * len(head)]
    for r in table[:top]:
        name = r["name"] if len(r["name"]) <= 48 else r["name"][:45] + "..."
        lines.append(f"{name:<48} {r['count']:>6} "
                     f"{r['self_us'] / 1e3:>9.3f} {r['avg_us']:>9.1f} "
                     f"{r['pct']:>6.1f}")
    if len(table) > top:
        rest = sum(r["self_us"] for r in table[top:])
        lines.append(f"{'... ' + str(len(table) - top) + ' more':<48} "
                     f"{'':>6} {rest / 1e3:>9.3f}")
    return "\n".join(lines)


def _main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("logdir", help="trace dir written by pyprof.trace(), or "
                                  "one trace file")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--python", action="store_true",
                   help="include python frames")
    p.add_argument("--csv", action="store_true")
    args = p.parse_args(argv)
    table = op_table(load(args.logdir), include_python=args.python)
    if args.csv:
        print("name,count,total_us,self_us,avg_us,pct")
        for r in table:
            print(f"\"{r['name']}\",{r['count']},{r['total_us']:.3f},"
                  f"{r['self_us']:.3f},{r['avg_us']:.3f},{r['pct']:.2f}")
    else:
        print(format_table(table, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
