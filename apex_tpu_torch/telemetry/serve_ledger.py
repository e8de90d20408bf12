"""Per-request serving latency ledger: every wall-second of every
request's life is attributed to exactly ONE class, and the partition is
EXACT.

Copy of the JAX package's ``apex_tpu/telemetry/serve_ledger.py``, which
imports no JAX; the port keeps its own copy so it imports nothing of that
package.  The snapshot schema is the same, so a port's ledger passes the
JAX package's ``serve_violations``.  The classes::

    queue         admitted-but-not-yet-prefilled wait (arrival -> the
                  scheduler picks the request up)
    prefill       the full-prompt forward that populates the request's
                  KV pages and produces its first token
    decode        the request's share of continuous-batching decode
                  steps (minus any measured exposed-comm carve)
    exposed_comm  the measured exposed-collective share of decode time
                  under a tp-sharded decode step; without a measurement
                  this class honestly reads 0 (unmeasured, not "hidden")
    shed          the tail of a request that was SHED — on pool
                  exhaustion (``KVCacheExhaustedError``) the request's
                  currently open phase closes as ``shed``, so the cost of
                  typed load-shedding is metered, never silently dropped

Request phases are CONTIGUOUS by construction (a request is in exactly
one phase at a time), so the ledger stores integer microseconds and the
partition is exact to the microsecond: ``sum(classes) == wall`` with
tolerance ZERO, asserted per request by :func:`serve_violations`.  The
ledger itself does ZERO host syncs: every number is a host
``perf_counter`` microsecond.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "CLASSES", "ARTIFACT_NAME", "ServeLedger", "serve_violations",
    "format_ledger", "load_artifact", "cli",
]

#: the per-request partition; every microsecond of a request's wall
#: time lands in exactly one of these
CLASSES = ("queue", "prefill", "decode", "exposed_comm", "shed")

#: canonical artifact filename (the goodput GOODPUT.json convention)
ARTIFACT_NAME = "SERVE.json"

#: per_request rows kept in the artifact (aggregates cover the rest —
#: the flight-recorder bounded-detail posture)
_MAX_ROWS = 128


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class _Req:
    __slots__ = ("rid", "submit_us", "end_us", "cur_cls", "cur_t0",
                 "segs", "status", "ttft_us", "tokens", "prompt_len")

    def __init__(self, rid, t_us, prompt_len):
        self.rid = rid
        self.submit_us = t_us
        self.end_us = None
        self.cur_cls = "queue"
        self.cur_t0 = t_us
        self.segs = {c: 0 for c in CLASSES}
        self.status = "active"
        self.ttft_us = None
        self.tokens = 0
        self.prompt_len = prompt_len


class ServeLedger:
    """Accumulates per-request phase time in integer microseconds.

    Usage (the scheduler does all of this)::

        led = ServeLedger()
        led.submit(rid, prompt_len=17)      # opens the queue phase
        led.phase(rid, "prefill"); ...; led.phase(rid, "decode")
        led.note_first_token(rid)           # TTFT
        led.note_tokens(rid, 1)             # per decoded token
        led.finish(rid)                     # or led.finish(rid, status="shed")
        doc = led.snapshot(); led.write(directory=run_dir)

    A request is in exactly one phase at any time, so per-request class
    sums telescope to the request wall EXACTLY (integer microseconds,
    zero tolerance).  ``finish(status="shed")`` closes the open phase
    as ``shed`` — the cost of typed load-shedding stays metered.
    A disabled ledger is a true no-op.
    """

    def __init__(self, *, enabled: bool = True, max_requests: int = 100_000):
        self.enabled = bool(enabled)
        self.max_requests = int(max_requests)
        self.dropped_requests = 0
        self._reqs: Dict[Any, _Req] = {}
        self._order: List[Any] = []
        # measured exposed-comm fraction of decode time under a
        # tp-sharded decode (timeline decomposition); 0 = unmeasured
        self._exposed_frac = 0.0

    # -- phase ingestion (host ints only; zero syncs) -----------------------
    def submit(self, rid, *, prompt_len: int = 0,
               t_us: Optional[int] = None) -> None:
        if not self.enabled:
            return
        if len(self._reqs) >= self.max_requests:
            self.dropped_requests += 1
            return
        t = _now_us() if t_us is None else int(t_us)
        self._reqs[rid] = _Req(rid, t, int(prompt_len))
        self._order.append(rid)

    def _close_seg(self, r: _Req, t: int, as_cls: Optional[str] = None) -> None:
        dur = max(t - r.cur_t0, 0)
        cls = as_cls or r.cur_cls
        if cls == "decode" and self._exposed_frac > 0.0:
            # the measured tp exposed-comm carve — still telescopes:
            # the two parts sum to dur exactly (integer split)
            exp = int(round(self._exposed_frac * dur))
            r.segs["exposed_comm"] += exp
            r.segs["decode"] += dur - exp
        else:
            r.segs[cls] += dur
        r.cur_t0 = t

    def phase(self, rid, cls: str, *, t_us: Optional[int] = None) -> None:
        """Close the request's open phase at ``t`` and open ``cls``."""
        r = self._reqs.get(rid)
        if not self.enabled or r is None or r.status != "active":
            return
        if cls not in CLASSES:
            raise ValueError(f"unknown serve ledger class {cls!r}")
        t = _now_us() if t_us is None else int(t_us)
        self._close_seg(r, t)
        r.cur_cls = cls

    def note_first_token(self, rid, *, t_us: Optional[int] = None) -> None:
        r = self._reqs.get(rid)
        if not self.enabled or r is None or r.ttft_us is not None:
            return
        t = _now_us() if t_us is None else int(t_us)
        r.ttft_us = max(t - r.submit_us, 0)

    def note_tokens(self, rid, n: int = 1) -> None:
        r = self._reqs.get(rid)
        if self.enabled and r is not None:
            r.tokens += int(n)

    def finish(self, rid, *, status: str = "done",
               t_us: Optional[int] = None) -> None:
        """Close the request.  ``status="shed"`` attributes the open
        phase's time to the ``shed`` class (the metered cost of typed
        load-shedding); any other status closes it as itself."""
        r = self._reqs.get(rid)
        if not self.enabled or r is None or r.status != "active":
            return
        t = _now_us() if t_us is None else int(t_us)
        self._close_seg(r, t, as_cls="shed" if status == "shed" else None)
        r.status = status
        r.end_us = t

    def set_exposed_fraction(self, fraction) -> None:
        """Feed the measured exposed-collective share of decode-step
        time (a tp-sharded decode under a device-timeline capture) so
        that share of every subsequent decode segment is carved into
        ``exposed_comm``.  Never fed on an unsharded/unmeasured run:
        the class honestly reads 0 there."""
        f = float(fraction or 0.0)
        self._exposed_frac = min(max(f, 0.0), 1.0)

    # -- the snapshot --------------------------------------------------------
    def snapshot(self, *, now_us: Optional[int] = None,
                 olevel: Optional[str] = None,
                 decode_width: Optional[int] = None,
                 compression_ratio: Optional[float] = None) -> dict:
        """JSON-serializable doc.  Finished requests partition exactly;
        still-active requests contribute their CLOSED segments plus are
        counted ``active`` (their open phase is not guessed at)."""
        now = _now_us() if now_us is None else int(now_us)
        totals = {c: 0 for c in CLASSES}
        e2e_ms: List[float] = []
        ttft_ms: List[float] = []
        counts = {"submitted": 0, "served": 0, "shed": 0, "active": 0}
        tokens_out = 0
        first_submit, last_end = None, None
        rows = []
        max_part_err = 0
        for rid in self._order:
            r = self._reqs[rid]
            counts["submitted"] += 1
            tokens_out += r.tokens
            if first_submit is None or r.submit_us < first_submit:
                first_submit = r.submit_us
            if r.status == "active":
                counts["active"] += 1
            else:
                counts["served" if r.status == "done" else "shed"] += 1
                wall = r.end_us - r.submit_us
                max_part_err = max(max_part_err,
                                   abs(sum(r.segs.values()) - wall))
                if last_end is None or r.end_us > last_end:
                    last_end = r.end_us
                if r.status == "done":
                    e2e_ms.append(wall / 1e3)
                    if r.ttft_us is not None:
                        ttft_ms.append(r.ttft_us / 1e3)
                if len(rows) < _MAX_ROWS:
                    rows.append({
                        "rid": str(r.rid), "status": r.status,
                        "wall_us": wall, "prompt_len": r.prompt_len,
                        "tokens": r.tokens, "ttft_us": r.ttft_us,
                        "classes_us": dict(r.segs),
                    })
            for c in CLASSES:
                totals[c] += r.segs[c]
        span_us = max((last_end or now) - (first_submit or now), 0)
        total_us = sum(totals.values())
        classes = {}
        for c in CLASSES:
            classes[c] = {
                "ms": round(totals[c] / 1e3, 6),
                "fraction": round(totals[c] / total_us, 6)
                if total_us > 0 else 0.0,
            }
        e2e_ms.sort()
        ttft_ms.sort()
        doc = {
            "kind": "serve_ledger",
            "version": 1,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "wall_ms": round(span_us / 1e3, 6),
            "request_ms": round(total_us / 1e3, 6),
            "classes": classes,
            "requests": counts,
            "latency_ms": {
                "p50": round(_pct(e2e_ms, 0.50), 6),
                "p99": round(_pct(e2e_ms, 0.99), 6),
                "mean": round(sum(e2e_ms) / len(e2e_ms), 6)
                if e2e_ms else 0.0,
                "ttft_p50": round(_pct(ttft_ms, 0.50), 6),
            },
            "tokens_out": tokens_out,
            "tokens_per_sec": round(tokens_out / (span_us / 1e6), 6)
            if span_us > 0 else 0.0,
            "partition_error_us": max_part_err,
            "dropped_requests": self.dropped_requests,
            "per_request": rows,
        }
        if olevel is not None:
            doc["olevel"] = str(olevel)
        if decode_width is not None:
            doc["decode_width"] = int(decode_width)
        if compression_ratio is not None:
            doc["compression_ratio"] = round(float(compression_ratio), 6)
        return doc

    # -- exports -------------------------------------------------------------
    def observe(self, registry, doc: Optional[dict] = None) -> None:
        """Export the running aggregates as plain-float gauges (they
        resolve in the registry's ONE batched flush read)."""
        if registry is None or not getattr(registry, "enabled", False) \
                or not self.enabled:
            return
        if doc is None:
            doc = self.snapshot()
        req = doc["requests"]
        registry.gauge("serve.requests_submitted").set(req["submitted"])
        registry.gauge("serve.requests_served").set(req["served"])
        registry.gauge("serve.requests_shed").set(req["shed"])
        registry.gauge("serve.p50_ms").set(doc["latency_ms"]["p50"])
        registry.gauge("serve.p99_ms").set(doc["latency_ms"]["p99"])
        registry.gauge("serve.ttft_ms").set(doc["latency_ms"]["ttft_p50"])
        registry.gauge("serve.tokens_per_sec").set(doc["tokens_per_sec"])
        for c in CLASSES:
            registry.gauge(f"serve.{c}_ms").set(doc["classes"][c]["ms"])

    def observe_flush(self, registry) -> None:
        """``Registry.flush`` hook (the MemoryMonitor/goodput shape)."""
        self.observe(registry)

    # -- the artifact --------------------------------------------------------
    def write(self, path: Optional[str] = None,
              directory: Optional[str] = None,
              doc: Optional[dict] = None, **snapshot_kw) -> Optional[str]:
        """Write ``SERVE.json`` (atomic replace, writer-validates)."""
        if doc is None:
            doc = self.snapshot(**snapshot_kw)
        bad = serve_violations(doc)
        if bad:
            raise ValueError("serve ledger fails its schema: "
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
# schema
# ---------------------------------------------------------------------------

_is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
_is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)


def serve_violations(doc: Any) -> List[str]:
    """Schema complaints for a serve ledger doc (empty = valid).  The
    load-bearing checks: every per-request row's classes partition its
    wall EXACTLY (integer microseconds, tolerance zero), p99 is present
    whenever requests were served, the int8 O-level carries its metered
    compression ratio, and shed requests imply metered shed time."""
    if not isinstance(doc, dict):
        return [f"doc is not an object: {type(doc).__name__}"]
    out = []
    if doc.get("kind") != "serve_ledger":
        out.append(f"bad kind {doc.get('kind')!r}")
    if doc.get("version") != 1:
        out.append(f"unknown version {doc.get('version')!r}")
    classes = doc.get("classes")
    if not isinstance(classes, dict) or set(classes) != set(CLASSES):
        return out + [f"classes keys off-schema: "
                      f"{sorted(classes) if isinstance(classes, dict) else classes!r}"]
    total_frac = 0.0
    for c, row in classes.items():
        if not isinstance(row, dict) or not _is_num(row.get("ms")) \
                or not _is_num(row.get("fraction")):
            out.append(f"classes.{c}: needs numeric ms + fraction")
            continue
        if row["ms"] < 0:
            out.append(f"classes.{c}: negative ms {row['ms']}")
        total_frac += row["fraction"]
    req_ms = doc.get("request_ms")
    if _is_num(req_ms) and req_ms > 0 and abs(total_frac - 1.0) > 1e-3:
        out.append(f"class fractions sum to {total_frac}, not 1")
    req = doc.get("requests")
    if not (isinstance(req, dict)
            and all(_is_int(req.get(k)) and req[k] >= 0
                    for k in ("submitted", "served", "shed", "active"))):
        out.append("requests must carry int submitted/served/shed/active")
        req = None
    else:
        if req["served"] + req["shed"] + req["active"] != req["submitted"]:
            out.append("request counts do not add up: served+shed+active "
                       f"{req['served'] + req['shed'] + req['active']} "
                       f"!= submitted {req['submitted']}")
        if req["shed"] > 0:
            shed_ms = (classes.get("shed") or {}).get("ms")
            if not _is_num(shed_ms) or shed_ms <= 0:
                out.append(f"{req['shed']} requests shed but shed class "
                           "is not metered — silent drop")
    lat = doc.get("latency_ms")
    if not (isinstance(lat, dict)
            and all(_is_num(lat.get(k))
                    for k in ("p50", "p99", "mean", "ttft_p50"))):
        out.append("latency_ms must carry numeric p50/p99/mean/ttft_p50")
    elif req and req["served"] > 0 and lat["p99"] <= 0:
        out.append("requests served but p99 latency missing/zero")
    tps = doc.get("tokens_per_sec")
    if not _is_num(tps) or tps < 0:
        out.append(f"bad tokens_per_sec {tps!r}")
    pe = doc.get("partition_error_us")
    if not _is_int(pe) or pe != 0:
        out.append(f"per-request partition not exact: "
                   f"partition_error_us {pe!r} (must be 0)")
    for row in doc.get("per_request") or ():
        if not isinstance(row, dict):
            out.append("per_request row is not an object")
            continue
        segs = row.get("classes_us")
        if not (isinstance(segs, dict) and set(segs) == set(CLASSES)
                and all(_is_int(v) and v >= 0 for v in segs.values())):
            out.append(f"per_request[{row.get('rid')!r}]: bad classes_us")
            continue
        if _is_int(row.get("wall_us")) \
                and sum(segs.values()) != row["wall_us"]:
            out.append(f"per_request[{row.get('rid')!r}]: classes sum "
                       f"{sum(segs.values())} != wall {row['wall_us']} us")
    if doc.get("olevel") == "int8":
        cr = doc.get("compression_ratio")
        if not _is_num(cr) or cr <= 1.0:
            out.append(f"int8 O-level without a metered compression "
                       f"ratio > 1 (got {cr!r})")
    return out


# ---------------------------------------------------------------------------
# rendering / CLI
# ---------------------------------------------------------------------------

def format_ledger(doc: dict) -> str:
    req = doc.get("requests") or {}
    lat = doc.get("latency_ms") or {}
    lines = [
        f"serve ledger  (span {doc.get('wall_ms', 0.0):.1f} ms"
        + (f", olevel {doc['olevel']}" if doc.get("olevel") else "")
        + (f", width {doc['decode_width']}" if doc.get("decode_width")
           else "") + ")",
        f"  requests: {req.get('submitted', 0)} submitted  "
        f"{req.get('served', 0)} served  {req.get('shed', 0)} shed  "
        f"{req.get('active', 0)} active",
        f"  latency ms: p50 {lat.get('p50', 0.0):.2f}  "
        f"p99 {lat.get('p99', 0.0):.2f}  ttft {lat.get('ttft_p50', 0.0):.2f}",
        f"  tokens/sec: {doc.get('tokens_per_sec', 0.0):.1f}  "
        f"({doc.get('tokens_out', 0)} tokens)",
    ]
    if doc.get("compression_ratio"):
        lines.append(f"  weight compression: "
                     f"{doc['compression_ratio']:.2f}x")
    head = f"  {'class':<14}{'ms':>12}{'% of request time':>19}"
    lines += [head, "  " + "-" * (len(head) - 2)]
    for c in CLASSES:
        row = doc["classes"][c]
        lines.append(f"  {c:<14}{row['ms']:>12.3f}"
                     f"{100.0 * row['fraction']:>18.2f}%")
    lines.append(f"  (partition error {doc.get('partition_error_us', 0)} us)")
    if doc.get("dropped_requests"):
        lines.append(f"  WARNING: {doc['dropped_requests']} requests "
                     "dropped (ledger cap) — classes under-count")
    return "\n".join(lines)


def load_artifact(path: str) -> dict:
    """Load a serve ledger doc from ``SERVE.json`` or a run directory
    containing one (the goodput ``load_artifact`` shape)."""
    if os.path.isdir(path):
        cand = os.path.join(path, ARTIFACT_NAME)
        if not os.path.exists(cand):
            raise ValueError(f"{path}: no {ARTIFACT_NAME} in directory")
        path = cand
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as err:
            raise ValueError(f"{path}: not JSON ({err})")
    if not (isinstance(doc, dict) and doc.get("kind") == "serve_ledger"):
        raise ValueError(f"{path}: not a serve ledger artifact")
    return doc


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry serve <SERVE.json|run-dir>``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry serve",
        description="Render the per-request serving latency ledger "
                    "(queue/prefill/decode/exposed-comm/shed "
                    "attribution) from a SERVE.json artifact or a run "
                    "directory holding one.")
    ap.add_argument("path", help="SERVE.json or a run dir")
    ap.add_argument("--json", action="store_true",
                    help="print the ledger doc as one JSON document")
    args = ap.parse_args(argv)
    try:
        doc = load_artifact(args.path)
    except (OSError, ValueError) as err:
        print(f"serve: {err}")
        return 1
    if args.json:
        print(json.dumps(doc))
    else:
        print(format_ledger(doc))
    bad = serve_violations(doc)
    if bad:
        print("SCHEMA VIOLATIONS:\n  " + "\n  ".join(bad))
        return 1
    return 0
