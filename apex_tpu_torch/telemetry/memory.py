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

The static half -- "where do the bytes go at the step's peak" --
is :func:`memory_table` / :func:`memory_model` / :func:`format_memory_table`
with the JAX dict shapes (``peak_bytes``, ``peak_op``, ``by_class``,
``live_at_peak``, ``stats``), but its liveness sweep is the port's own:
the step RUNS once under :class:`.attrib.Recording`, whose rows are its
dispatched ops and kernel launches in order.  Each op's output storages get
a def at that op and a death at the first op after their storage has gone
(polled through ``StorageWeakRef``: autograd holds saved tensors in C++);
the caller's argument storages live for the whole call, classed by their
keypaths (:func:`classify_arg`, the JAX package's rules); storages the
result holds are ``output``; the rest live at the peak are
``activations`` (held across it) or ``temps`` (dead after it).  ``stats``
holds the caching allocator's own peak over the call on the card
(``torch.cuda.max_memory_allocated``), None on the CPU.  The JAX module's
``hlo_liveness`` and ``compiled_memory_stats`` read a compiled XLA
executable and have no counterpart.  ``memory_model(register=True)``
installs its result as the attribution the OOM dump embeds
(:func:`set_attribution`).
"""
from __future__ import annotations

import collections
import json
import re
from typing import Any, Dict, List, Optional

import torch

from . import trace as _trace

__all__ = [
    "MEM_CLASSES", "classify_arg", "memory_table", "memory_model",
    "format_memory_table", "device_memory_stats", "device_memory_json",
    "MemoryMonitor",
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
# static attribution: the liveness sweep over one recorded call
# ---------------------------------------------------------------------------

#: Peak-memory attribution classes.  ``params``/``optimizer``/``batch``/
#: ``args`` come from the call's argument keypaths; ``activations`` are
#: storages HELD across the peak op (live before and after it -- the
#: forward's tensors a backward is keeping), ``temps`` die at the peak,
#: ``output`` storages are the result's.  ``constants`` stays empty in the
#: port (no compiled constants), kept for the JAX partition.
MEM_CLASSES = ("params", "optimizer", "batch", "args", "constants",
               "activations", "temps", "output")

_OPT_KEYS = ("master", "opt_state", "scaler", "moment", "exp_avg",
             "'m'", "'v'", ".m[", ".v[", "adam", "lamb", "mu'", "nu'")
_PARAM_KEYS = ("model_params", "param", "weight", "kernel", "embed")
_BATCH_KEYS = ("token", "image", "label", "target", "batch", "input",
               "boost")
#: a bare terminal ``.m`` / ``.v`` / ``['m']`` / ``['v']`` field -- the
#: fused optimizer state's moment buffers; terminal-only, so
#: ``vectors`` / ``m_tokens`` never false-positive
_MOMENT_FIELD_RE = re.compile(r"(?:\.|\[')([mv])(?:'\])?$")


def classify_arg(path: str) -> str:
    """Bin one argument keypath (``state.master_params['w']``, ``tokens``)
    into its memory class, by the JAX package's rules.  Optimizer keys win
    over param keys: ``master_params`` is optimizer STATE (the fp32
    shadow), not the serving weights."""
    p = (path or "").replace("\\", "").lower()
    if any(k in p for k in _OPT_KEYS):
        return "optimizer"
    if any(k in p for k in _PARAM_KEYS):
        return "params"
    if _MOMENT_FIELD_RE.search(p):
        return "optimizer"
    if any(k in p for k in _BATCH_KEYS) or p in ("x", "y"):
        return "batch"
    return "args"


def liveness(rec, device) -> dict:
    """The sweep over a finished liveness :class:`.attrib.Recording`,
    counting the storages on ``device``: ``{peak_bytes, peak_index,
    peak_op, n_instructions, n_buffers, live_at_peak: [rows], by_class,
    timeline: [{i, bytes}]}``, ``by_class`` partitioning ``peak_bytes``
    exactly."""
    n = len(rec.rows)
    bufs = [b for b in rec.buffers
            if b["device"] == device and b["bytes"] > 0]
    if n == 0:
        return {"peak_bytes": 0, "peak_index": 0, "peak_op": "",
                "n_instructions": 0, "n_buffers": 0, "live_at_peak": [],
                "by_class": {}, "timeline": []}
    delta = [0] * (n + 1)
    for b in bufs:
        end = n - 1 if b["end"] is None else min(b["end"], n - 1)
        b["last"] = end
        delta[min(b["start"], n - 1)] += b["bytes"]
        delta[end + 1] -= b["bytes"]
    series: List[int] = []
    acc = 0
    for i in range(n):
        acc += delta[i]
        series.append(acc)
    peak_idx = max(range(n), key=lambda i: series[i])
    flops = {r["op"]: r["flops"] for r in rec.rows}
    rows: List[dict] = []
    by_class: Dict[str, int] = {}
    for b in bufs:
        if not (b["start"] <= peak_idx <= b["last"]):
            continue
        if b["cls"] is not None:
            cls = b["cls"]
        elif b.get("is_output"):
            cls = "output"
        elif b["last"] > peak_idx:
            cls = "activations"
        else:
            cls = "temps"
        rows.append({"op": b["op"], "opcode": b["opcode"], "class": cls,
                     "jax_op": b["op"] if b["opcode"] == "parameter"
                     else "", "bytes": b["bytes"],
                     "def_index": b["start"], "last_use": b["last"],
                     "flops": flops.get(b["op"], 0.0)})
        by_class[cls] = by_class.get(cls, 0) + b["bytes"]
    rows.sort(key=lambda r: -r["bytes"])
    stride = max(1, n // 256)
    return {"peak_bytes": series[peak_idx], "peak_index": peak_idx,
            "peak_op": rec.rows[peak_idx]["op"], "n_instructions": n,
            "n_buffers": len(bufs), "live_at_peak": rows,
            "by_class": by_class,
            "timeline": [{"i": i, "bytes": series[i]}
                         for i in range(0, n, stride)]}


def memory_table(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a liveness recording and
    return the peak-memory attribution of the device its arguments live
    on: the sweep (:func:`liveness`) plus ``stats`` -- on the card the
    allocator's peak over the call (``peak_bytes``), what was allocated
    before it (``allocated_before``), the argument storages' bytes
    (``argument_bytes``) and ``call_peak_bytes`` = peak - before +
    arguments, the allocator's count of what the sweep counts (it also
    holds the cuBLAS workspace and the 512-byte rounding), and
    ``allocated_at_peak_op_bytes``, the allocator's live bytes just after
    the sweep's peak op on the same terms; None on the CPU -- and
    ``platform``.  Unreachable garbage is collected first, so that
    ``before`` holds no tensor the call would free."""
    import gc
    from ..pyprof.prof import platform_of
    from .attrib import _device_of_args, record
    dev = _device_of_args(args, kwargs)
    on_card = dev.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _, rec = record(fn, *args, liveness=True,
                    allocator=dev if on_card else None, **kwargs)
    table = liveness(rec, dev)
    table["stats"] = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        arg_bytes = sum(b["bytes"] for b in rec.buffers
                        if b["opcode"] == "parameter" and b["device"] == dev)
        ambient = before - arg_bytes
        at_peak = (rec.allocated[table["peak_index"]]
                   if rec.allocated else before)
        table["stats"] = {"peak_bytes": int(peak),
                          "allocated_before": int(before),
                          "argument_bytes": int(arg_bytes),
                          "call_peak_bytes": int(peak - ambient),
                          "allocated_at_peak_op_bytes": int(at_peak
                                                            - ambient)}
    table["platform"] = platform_of(dev)
    return table


def memory_model(fn=None, *args, table: Optional[dict] = None,
                 register: bool = True, update_sharding_world: int = 1,
                 **kwargs) -> dict:
    """The compact per-class memory cost model (the shape the OOM
    post-mortem embeds).  Pass a precomputed ``table`` or let it run
    ``fn(*args)`` itself.  ``register=True`` installs the result as the
    process attribution (:func:`set_attribution`).
    ``update_sharding_world``: shard count of a weight-update-sharded
    run; ``optimizer_bytes_per_replica`` divides the optimizer class by
    it.  The named ``*_bytes`` keys partition ``peak_hbm_bytes``."""
    if table is None:
        table = memory_table(fn, *args, **kwargs)
    cls = table["by_class"]
    world = max(1, int(update_sharding_world))
    model = {
        "peak_hbm_bytes": int(table["peak_bytes"]),
        "platform": table.get("platform", "?"),
        "peak_op": table["peak_op"],
        "by_class": {k: int(v) for k, v in cls.items()},
        "params_bytes": int(cls.get("params", 0)),
        "optimizer_bytes": int(cls.get("optimizer", 0)),
        "optimizer_bytes_per_replica": int(cls.get("optimizer", 0)) // world,
        "update_sharding_world": world,
        "batch_bytes": int(cls.get("batch", 0)),
        "activations_bytes": int(cls.get("activations", 0)),
        "temps_bytes": int(cls.get("temps", 0)),
        "output_bytes": int(cls.get("output", 0)),
        "args_bytes": int(cls.get("args", 0)),
        "constants_bytes": int(cls.get("constants", 0)),
        "compiled": table.get("stats"),
        "top": [{"op": r["op"], "class": r["class"],
                 "bytes": int(r["bytes"]), "opcode": r["opcode"]}
                for r in table["live_at_peak"][:12]],
    }
    if register:
        set_attribution(model)
    return model


def format_memory_table(table: dict, top: int = 16) -> str:
    """Render the per-class peak table + the largest live storages --
    the ``python -m apex_tpu_torch.telemetry mem`` output."""
    peak = table["peak_bytes"]
    lines = [
        f"peak-memory attribution ({table.get('platform', '?')}; "
        f"{table['n_buffers']} storages over {table['n_instructions']} "
        f"ops; peak at #{table['peak_index']} ({table['peak_op']}))",
        "per-class residency at peak",
    ]
    by_class = table["by_class"]
    for cls in MEM_CLASSES:
        b = by_class.get(cls)
        if b is None:
            continue
        pct = 100.0 * b / peak if peak else 0.0
        lines.append(f"  {cls:<12} {_human(b, 'B'):>12} {pct:>6.1f}%")
    lines.append(f"  {'total':<12} {_human(peak, 'B'):>12} "
                 f"(= liveness-sweep peak)")
    rows = table["live_at_peak"][:top]
    if rows:
        lines.append(f"largest live storages at peak (top {len(rows)})")
        lines.append(f"  {'op':<28} {'opcode':<12} {'class':<12} "
                     f"{'bytes':>12} {'flops':>10}")
        for r in rows:
            name = r["op"] if len(r["op"]) <= 28 else r["op"][:25] + "..."
            opcode = r["opcode"] if len(r["opcode"]) <= 12 \
                else r["opcode"][:9] + "..."
            lines.append(
                f"  {name:<28} {opcode:<12} {r['class']:<12} "
                f"{_human(r['bytes'], 'B'):>12} "
                f"{_human(r.get('flops', 0.0)):>10}")
    stats = table.get("stats")
    if stats:
        lines.append(
            f"allocator: peak {_human(stats['peak_bytes'], 'B')} over the "
            f"call, {_human(stats['allocated_before'], 'B')} allocated "
            f"before it, arguments {_human(stats['argument_bytes'], 'B')}"
            f"  -> call peak {_human(stats['call_peak_bytes'], 'B')}")
    return "\n".join(lines)


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
    """``python -m apex_tpu_torch.telemetry mem [flight-oom-*.json]
    [--top N]``: with a path, render an OOM post-mortem; with none, run
    the demo transformer step once on ``--device`` (default the card) and
    render its peak-memory table."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry mem",
        description="Peak-memory attribution: with no argument, run the "
                    "demo transformer train step once and render the "
                    "per-class liveness table; with a path, render a "
                    "flight-oom-*.json post-mortem.")
    ap.add_argument("artifact", nargs="?", default=None,
                    help="a flight-oom-*.json dump")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="the demo's device (default: cuda)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if args.artifact is None:
        from .report import demo_step_fn
        train_step, state, make_batch = demo_step_fn(
            layers=args.layers, batch=args.batch, seq=args.seq,
            device=args.device)
        tokens, targets = make_batch(0)
        boost = torch.ones((), device=tokens.device)
        table = memory_table(train_step, state, tokens, targets, boost)
        print(format_memory_table(table, top=args.top))
        model = memory_model(table=table)    # registers the attribution
        print(f"memory_model: peak {_human(model['peak_hbm_bytes'], 'B')}  "
              f"params {_human(model['params_bytes'], 'B')}  "
              f"optimizer {_human(model['optimizer_bytes'], 'B')}  "
              f"activations {_human(model['activations_bytes'], 'B')}  "
              f"temps {_human(model['temps_bytes'], 'B')}")
        return 0
    with open(args.artifact) as f:
        doc = json.load(f)
    bad = oom_violations(doc)
    if bad:
        print(f"{args.artifact}: not an OOM post-mortem: {bad[0]}")
        return 1
    return _render_oom_dump(doc, args.top)
