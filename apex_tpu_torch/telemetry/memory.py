"""Memory observability, the live and OOM half: where the device bytes go
while a run lives, and what was live when it ran out.

Counterpart of the JAX package's ``apex_tpu/telemetry/memory.py``, with
its public names and its OOM dump schema (the JAX ``oom_violations``
accepts the port's ``flight-oom-*.json``).  Two pieces:

  * **live gauges** -- :class:`MemoryMonitor` reads the caching
    allocator's counters (:func:`device_memory_stats`, over
    ``torch.cuda.memory_stats``: a host-side read, no device sync) from
    inside ``Registry.flush()``, emitting ``mem.*`` gauges plus a
    ``device_mem`` Chrome counter track through the default tracer.
    Disabled (``APEX_TPU_TELEMETRY_MEM=0``) or unsupported (no CUDA) the
    monitor is a no-op after one probe.
  * **OOM post-mortem** -- :func:`is_oom_error` recognizes
    ``torch.cuda.OutOfMemoryError`` (and out-of-memory text, and the
    injected :func:`synthetic_oom`), :func:`parse_allocator_report`
    reads the requested size from torch's message (or the JAX package's
    allocator stanzas) and the largest live blocks from
    ``torch.cuda.memory_snapshot()``, and :func:`dump_oom` writes a
    schema-validated ``flight-oom-<ts>.json`` (flight-recorder ring,
    live-memory history, the registered static attribution, the faulting
    step).

The static half of the JAX module -- ``memory_table``, ``memory_model``,
``hlo_liveness``, ``compiled_memory_stats`` and ``format_memory_table``,
which read a compiled XLA executable -- needs a base of its own in the
port (the torch profiler and FLOP counting) and is not ported yet;
:func:`set_attribution` takes any dict of that shape.
"""
from __future__ import annotations

import collections
import json
import re
from typing import Any, Dict, List, Optional

import torch

from . import trace as _trace

__all__ = [
    "device_memory_stats", "device_memory_json", "MemoryMonitor",
    "InjectedOomError", "synthetic_oom", "is_oom_error",
    "parse_allocator_report", "set_attribution", "get_attribution",
    "oom_violations", "dump_oom", "cli",
]


def _human(n, unit: str = "") -> str:
    """Bytes (or any count) in K / M / G / T steps of 1000."""
    if n is None:
        return "n/a"
    n = float(n)
    for mag, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= mag:
            return f"{n / mag:.2f} {suffix}{unit}"
    return f"{n:.0f} {unit}".rstrip()


# ---------------------------------------------------------------------------
# live gauges
# ---------------------------------------------------------------------------

def device_memory_stats(device=None) -> Optional[dict]:
    """ONE host-side read of the CUDA caching allocator's counters, under
    the JAX package's key names: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` (allocated at peak since the last
    ``reset_peak_memory_stats``, what ``torch.cuda.max_memory_allocated``
    gives), ``bytes_reserved``, ``num_allocs`` and ``bytes_limit`` (the
    card's memory).  None without CUDA."""
    try:
        if not torch.cuda.is_available():
            return None
        if device is None:
            device = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:
        return None
    if not stats:
        return None
    out = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                              0)),
           "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
           "num_allocs": int(stats.get("allocation.all.current", 0)),
           "bytes_limit": int(limit)}
    return out


def device_memory_json() -> str:
    """The allocator counters as a one-line JSON object (a counter
    track's args), or the empty string when unsupported."""
    stats = device_memory_stats()
    if not stats:
        return ""
    keys = ("bytes_in_use", "peak_bytes_in_use", "largest_alloc_size",
            "bytes_limit", "num_allocs")
    picked = {k: stats[k] for k in keys if k in stats}
    return json.dumps(picked or stats)


class MemoryMonitor:
    """Polls the device allocator at registry-flush cadence.

    ``Registry.flush()`` calls :meth:`observe_flush`: the poll sets
    ``mem.bytes_in_use`` / ``mem.peak_bytes_in_use`` gauges (plain host
    floats: they add nothing to the flush's one device read), appends to
    a bounded history ring (the OOM post-mortem embeds it), and emits a
    ``device_mem`` Chrome counter track through the default tracer.
    Disabled (``enabled=False`` / ``APEX_TPU_TELEMETRY_MEM=0``) or
    unsupported (first poll found no stats: cached), every call is a
    single attribute check."""

    def __init__(self, *, enabled: Optional[bool] = None,
                 history: int = 512, device=None):
        self.enabled = (_trace.env_flag("APEX_TPU_TELEMETRY_MEM")
                        if enabled is None else bool(enabled))
        self.history: "collections.deque" = collections.deque(
            maxlen=int(history))
        self._device = device
        self._unsupported = False

    @property
    def supported(self) -> Optional[bool]:
        """False once a poll found no allocator stats; None before the
        first poll resolves it."""
        return False if self._unsupported else None

    def poll(self) -> Optional[dict]:
        if not self.enabled or self._unsupported:
            return None
        stats = device_memory_stats(self._device)
        if stats is None:
            self._unsupported = True     # never probe again
            return None
        out = {"bytes_in_use": float(stats.get("bytes_in_use", 0)),
               "peak_bytes_in_use": float(
                   stats.get("peak_bytes_in_use", 0))}
        if "largest_alloc_size" in stats:
            out["largest_alloc_bytes"] = float(stats["largest_alloc_size"])
        if stats.get("bytes_limit"):
            out["bytes_limit"] = float(stats["bytes_limit"])
        return out

    def observe_flush(self, reg) -> Optional[dict]:
        """The registry-flush hook: poll once, gauge + ring + counter
        track.  Returns the polled stats (None when disabled or
        unsupported, and then does nothing else)."""
        stats = self.poll()
        if stats is None:
            return None
        step = int(getattr(reg, "_step", 0))
        for key in ("bytes_in_use", "peak_bytes_in_use",
                    "largest_alloc_bytes"):
            if key in stats:
                reg.gauge("mem." + key).set(stats[key])
        self.history.append({"step": step,
                             "bytes_in_use": stats["bytes_in_use"],
                             "peak_bytes_in_use":
                                 stats["peak_bytes_in_use"]})
        _trace.note_counter(
            "device_mem", step=step,
            values={"bytes_in_use": stats["bytes_in_use"],
                    "peak_bytes_in_use": stats["peak_bytes_in_use"]})
        return stats

    def snapshot(self) -> List[dict]:
        return list(self.history)


# ---------------------------------------------------------------------------
# OOM post-mortem
# ---------------------------------------------------------------------------

class InjectedOomError(RuntimeError):
    """The deterministic ``oom@N`` fault: its message is shaped like
    torch's CUDA out-of-memory report, so the post-mortem parser is
    tested against the format it must survive."""


def synthetic_oom(step: int, nbytes: int = 2 ** 31) -> InjectedOomError:
    return InjectedOomError(
        f"CUDA out of memory. Tried to allocate "
        f"{nbytes / 2 ** 30:.2f} GiB. [injected oom fault at step "
        f"{int(step)}]")


def is_oom_error(err: BaseException) -> bool:
    """True for allocator exhaustion: ``torch.cuda.OutOfMemoryError``,
    the injected fault, or a failure whose text says out of memory (the
    JAX package's ``RESOURCE_EXHAUSTED`` included)."""
    if isinstance(err, (InjectedOomError, torch.cuda.OutOfMemoryError)):
        return True
    s = f"{type(err).__name__}: {err}"
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


_TRIED_RE = re.compile(r"Tried to allocate\s+([0-9.]+)\s*([KMGTP]?i?B)",
                       re.I)
_REQ_RE = re.compile(r"allocat\w*\s+(\d+)\s+bytes", re.I)
_SIZE_RE = re.compile(
    r"^\s*\d+\.\s+Size:\s*([0-9.]+)\s*([KMGTP]?i?B?)\s*$", re.M)
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_SHAPE_LINE_RE = re.compile(r"Shape:\s*(\S+)")
_ALLOC_TYPE_RE = re.compile(r"Allocation type:\s*([^\n]+)")

_SIZE_MULT = {"": 1, "B": 1,
              "K": 1e3, "KB": 1e3, "KIB": 2 ** 10,
              "M": 1e6, "MB": 1e6, "MIB": 2 ** 20,
              "G": 1e9, "GB": 1e9, "GIB": 2 ** 30,
              "T": 1e12, "TB": 1e12, "TIB": 2 ** 40}


def _size_bytes(num: str, suffix: str) -> int:
    return int(float(num) * _SIZE_MULT.get(suffix.upper(), 1))


def _snapshot_allocations(snapshot) -> List[dict]:
    """The live blocks of a ``torch.cuda.memory_snapshot()``, largest
    first: ``{size_bytes, alloc_type, shape}`` (the block's state and
    its segment's type)."""
    allocs = []
    for seg in snapshot or ():
        if not isinstance(seg, dict):
            continue
        for blk in seg.get("blocks", ()):
            state = blk.get("state", "")
            if state != "active_allocated":
                continue
            allocs.append({"size_bytes": int(blk.get("size", 0)),
                           "alloc_type": str(state)[:40],
                           "shape": f"{seg.get('segment_type', '?')} "
                                    f"segment"[:80]})
    allocs.sort(key=lambda a: -a["size_bytes"])
    return allocs


def parse_allocator_report(text: str, snapshot=None) -> dict:
    """Tolerant parse of an allocator failure: the requested byte count
    (torch's "Tried to allocate 2.00 GiB", or the JAX package's "allocate
    N bytes") and the largest allocations, from ``snapshot`` (a
    ``torch.cuda.memory_snapshot()``: its live blocks) and from the
    text's "Largest program allocations" stanzas where it has them.
    Anything it cannot read is simply absent."""
    text = str(text)
    tried = _TRIED_RE.search(text)
    req = _REQ_RE.search(text)
    requested = (_size_bytes(tried.group(1), tried.group(2)) if tried
                 else int(req.group(1)) if req else None)
    allocations: List[dict] = _snapshot_allocations(snapshot)
    headers = list(_SIZE_RE.finditer(text))
    for i, m in enumerate(headers):
        stanza_end = (headers[i + 1].start() if i + 1 < len(headers)
                      else len(text))
        stanza = text[m.end():stanza_end]
        alloc = {"size_bytes": _size_bytes(m.group(1), m.group(2))}
        nm = _OPNAME_RE.search(stanza)
        if nm:
            alloc["operator"] = nm.group(1)[:200]
        sm = _SHAPE_LINE_RE.search(stanza)
        if sm:
            alloc["shape"] = sm.group(1)[:80]
        tm = _ALLOC_TYPE_RE.search(stanza)
        if tm:
            alloc["alloc_type"] = tm.group(1).strip()[:40]
        allocations.append(alloc)
    return {"requested_bytes": requested, "allocations": allocations}


# -- the process attribution (what the OOM dump embeds) ----------------------

_attribution: Optional[dict] = None


def set_attribution(model: Optional[dict]) -> Optional[dict]:
    """Install the static attribution (a ``memory_model``-shaped dict,
    ``peak_hbm_bytes`` an int) the OOM post-mortem embeds; None
    uninstalls.  Returns the previous one so tests can restore it."""
    global _attribution
    prev = _attribution
    _attribution = model
    return prev


def get_attribution() -> Optional[dict]:
    return _attribution


_is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)


def _oom_section_violations(sec: Any) -> List[str]:
    if not isinstance(sec, dict):
        return ["oom section is not an object"]
    out = []
    if not _is_int(sec.get("bad_step")):
        out.append(f"oom: bad_step must be an int, got "
                   f"{sec.get('bad_step')!r}")
    if not isinstance(sec.get("error"), str):
        out.append("oom: missing error text")
    if not isinstance(sec.get("error_type"), str):
        out.append("oom: missing error_type")
    req = sec.get("requested_bytes")
    if req is not None and not _is_int(req):
        out.append(f"oom: requested_bytes must be int/null, got {req!r}")
    allocs = sec.get("allocations")
    if not isinstance(allocs, list):
        out.append("oom: allocations must be a list")
    else:
        for i, a in enumerate(allocs):
            if not isinstance(a, dict) or not _is_int(a.get("size_bytes")):
                out.append(f"oom: allocations[{i}] needs int size_bytes")
    hist = sec.get("live_memory")
    if not isinstance(hist, list):
        out.append("oom: live_memory must be a list")
    attr = sec.get("attribution")
    if attr is not None and not (isinstance(attr, dict)
                                 and _is_int(attr.get("peak_hbm_bytes"))):
        out.append("oom: attribution must be null or a memory_model dict "
                   "(peak_hbm_bytes int)")
    return out


def oom_violations(doc: Any) -> List[str]:
    """Schema complaints for a ``flight-oom-*.json`` post-mortem dump
    (the flight-recorder schema plus the ``oom`` section)."""
    out = _trace.dump_violations(doc)
    sec = doc.get("oom") if isinstance(doc, dict) else None
    if sec is None:
        out.append("missing 'oom' section")
    else:
        out.extend(_oom_section_violations(sec))
    return out


def _live_snapshot():
    """``torch.cuda.memory_snapshot()`` where CUDA is up, else None."""
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda.memory_snapshot()
    except Exception:
        pass
    return None


def dump_oom(recorder=None, *, step: int, error: BaseException,
             directory: Optional[str] = None, path: Optional[str] = None,
             registry=None, attribution: Optional[dict] = None,
             snapshot=None) -> Optional[str]:
    """Write the OOM post-mortem ``flight-oom-<ts>.json``: the flight
    ring (``recorder``; a fresh empty one when the run was untraced),
    the parsed allocator report (``snapshot``: a
    ``torch.cuda.memory_snapshot()``, taken here when None and CUDA is
    up; False for none), the registry monitor's live-memory history,
    and the registered static attribution.  Writer-validated against
    :func:`oom_violations` before it touches disk."""
    if recorder is None:
        recorder = _trace.FlightRecorder(capacity=8)
    if snapshot is None:
        snapshot = _live_snapshot()
    report = parse_allocator_report(str(error), snapshot or None)
    monitor = getattr(registry, "_memory", None) if registry is not None \
        else None
    section = {
        "bad_step": int(step),
        "error_type": type(error).__name__,
        "error": str(error)[:4000],
        "requested_bytes": report["requested_bytes"],
        "allocations": report["allocations"][:16],
        "live_memory": monitor.snapshot() if monitor is not None else [],
        "attribution": (attribution if attribution is not None
                        else get_attribution()),
    }
    bad = _oom_section_violations(section)
    if bad:   # writer-validates, the JsonlSink posture
        raise ValueError("oom post-mortem fails its schema: "
                         + "; ".join(bad[:4]))
    return recorder.dump(
        "oom", step=step, directory=directory, path=path,
        fields={"bad_step": int(step),
                "error_type": type(error).__name__},
        sections={"oom": section})


# ---------------------------------------------------------------------------
# CLI: python -m apex_tpu_torch.telemetry mem
# ---------------------------------------------------------------------------

def _render_oom_dump(doc: dict, top: int) -> int:
    sec = doc.get("oom") or {}
    lines = [f"OOM post-mortem ({doc.get('ts')}; "
             f"bad_step={sec.get('bad_step')}; "
             f"{sec.get('error_type')})"]
    if sec.get("requested_bytes") is not None:
        lines.append(f"  requested        "
                     f"{_human(sec['requested_bytes'], 'B')}")
    allocs = sec.get("allocations") or []
    if allocs:
        lines.append(f"  top allocations  ({len(allocs)})")
        for a in allocs[:top]:
            lines.append(f"    {_human(a.get('size_bytes'), 'B'):>12}  "
                         f"{a.get('alloc_type', '?'):<16} "
                         f"{a.get('operator', a.get('shape', ''))[:60]}")
    hist = sec.get("live_memory") or []
    if hist:
        last = hist[-1]
        lines.append(f"  live memory      {len(hist)} samples; last: "
                     f"in-use {_human(last.get('bytes_in_use'), 'B')} "
                     f"peak {_human(last.get('peak_bytes_in_use'), 'B')} "
                     f"@ step {last.get('step')}")
    attr = sec.get("attribution")
    if attr:
        lines.append(f"  expected peak    "
                     f"{_human(attr.get('peak_hbm_bytes'), 'B')} "
                     f"(static attribution)")
        for cls, b in sorted((attr.get("by_class") or {}).items(),
                             key=lambda kv: -kv[1]):
            lines.append(f"    {cls:<12} {_human(b, 'B'):>12}")
    lines.append(f"  ring entries     {doc.get('n_entries', 0)}")
    print("\n".join(lines))
    return 0


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry mem <flight-oom-*.json>
    [--top N]``: render an OOM post-mortem.  (The JAX package's
    no-argument form compiles a step and renders its static peak-memory
    table; that half is not ported.)"""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry mem",
        description="Render a flight-oom-*.json OOM post-mortem.")
    ap.add_argument("artifact", help="a flight-oom-*.json dump")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    with open(args.artifact) as f:
        doc = json.load(f)
    bad = oom_violations(doc)
    if bad:
        print(f"{args.artifact}: not an OOM post-mortem: {bad[0]}")
        return 1
    return _render_oom_dump(doc, args.top)
