"""Live OpenMetrics/Prometheus export of the registry's flush window.

Counterpart of the JAX package's ``apex_tpu/telemetry/export.py``: the
same text for the same snapshot (series keep the ``apex_tpu_`` prefix, so
one scrape config reads both packages).  A pull-based endpoint (stdlib
``http.server`` on a daemon thread) serves whatever the LAST
``Registry.flush()`` resolved:

  * the snapshot is taken INSIDE the flush: the exporter receives the
    already-resolved records (plain host floats) and copies them under a
    lock, so it adds no device read;
  * disabled mode is a no-op: without ``APEX_TPU_METRICS_PORT`` no
    exporter object exists, no thread starts, and ``Registry.flush``
    pays one module-default check.

Scrape surface (``GET /metrics``, OpenMetrics text): every metric from
the last flush as ``apex_tpu_<name>`` (dots sanitized to underscores),
histograms as ``_count/_sum/_min/_max/_mean`` series, cumulative event
counts as ``apex_tpu_events_total{name="..."}`` (the serving scheduler's
``serve.*`` gauges among them); run identity rides
``apex_tpu_build_info``.  It binds ``127.0.0.1`` by default.

``APEX_TPU_METRICS_PORT=<port>`` arms the process default through
:func:`maybe_start` (port ``0`` asks the OS for an ephemeral port);
:func:`shutdown` stops it.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

__all__ = [
    "MetricsExporter", "env_port", "install", "get_exporter",
    "maybe_start", "render_openmetrics", "shutdown",
]

ENV_PORT = "APEX_TPU_METRICS_PORT"


def env_port() -> Optional[int]:
    """The armed port, or None when the env leaves the exporter off
    (unset / empty / non-integer / negative).  ``0`` is a real value:
    bind an OS-assigned ephemeral port."""
    raw = os.environ.get(ENV_PORT)
    if raw is None or not raw.strip():
        return None
    try:
        port = int(raw.strip())
    except ValueError:
        return None
    return port if 0 <= port <= 65535 else None


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_openmetrics(snapshot: Dict[str, Any], meta: Dict[str, Any],
                       event_counts: Dict[str, int]) -> str:
    """The text exposition (pure function of the snapshot — the unit
    the format tests pin)."""
    lines: List[str] = []
    run = str(meta.get("run") or "")
    lines.append("# TYPE apex_tpu_build_info gauge")
    lines.append('apex_tpu_build_info{run="%s"} 1' % run.replace('"', "'"))
    lines.append("# TYPE apex_tpu_last_flush_step gauge")
    lines.append(f"apex_tpu_last_flush_step {int(meta.get('step', 0))}")
    lines.append("# TYPE apex_tpu_flushes gauge")
    lines.append(f"apex_tpu_flushes {int(meta.get('flushes', 0))}")
    for name in sorted(snapshot):
        row = snapshot[name]
        base = "apex_tpu_" + _sanitize(name)
        kind = row.get("type", "gauge")
        if kind == "histogram":
            for stat, v in sorted((row.get("stats") or {}).items()):
                lines.append(f"# TYPE {base}_{stat} gauge")
                lines.append(f"{base}_{stat} {_fmt(v)}")
            continue
        om_type = "counter" if kind == "counter" else "gauge"
        suffix = "_total" if om_type == "counter" else ""
        lines.append(f"# TYPE {base}{suffix} {om_type}")
        lines.append(f"{base}{suffix} {_fmt(row.get('value', 0.0))}")
    if event_counts:
        lines.append("# TYPE apex_tpu_events_total counter")
        for name in sorted(event_counts):
            lines.append('apex_tpu_events_total{name="%s"} %d'
                         % (_sanitize(name), event_counts[name]))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """One scrape endpoint fed by ``Registry.flush``.  Construction is
    cheap and bind-free; :meth:`start` binds and spins the daemon
    thread; :meth:`close` shuts it down (idempotent)."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 run_id: Optional[str] = None):
        self._requested_port = int(port)
        self._host = host
        self._lock = threading.Lock()
        self._snapshot: Dict[str, Any] = {}
        self._event_counts: Dict[str, int] = {}
        self._meta: Dict[str, Any] = {"run": run_id, "step": 0,
                                      "flushes": 0}
        self._server = None
        self._thread = None

    # -- identity ------------------------------------------------------------
    def set_meta(self, **fields) -> None:
        with self._lock:
            self._meta.update({k: v for k, v in fields.items()
                               if v is not None})

    @property
    def port(self) -> Optional[int]:
        return (self._server.server_address[1]
                if self._server is not None else None)

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return f"http://{self._host}:{p}/metrics" if p else None

    # -- the flush hook ------------------------------------------------------
    def observe_flush(self, registry, records: List[dict]) -> None:
        """Copy one flush window's already-resolved records.  Called by
        ``Registry.flush`` INSIDE its batched window: everything here
        is host floats — no device access, no sync."""
        snap: Dict[str, Any] = {}
        events: Dict[str, int] = {}
        step = 0
        run = None
        for rec in records:
            kind = rec.get("kind")
            if kind == "metric":
                step = max(step, int(rec.get("step", 0)))
                row: Dict[str, Any] = {"type": rec.get("type", "gauge")}
                if "stats" in rec:
                    row["type"] = "histogram"
                    row["stats"] = dict(rec["stats"])
                elif "value" in rec:
                    row["value"] = rec["value"]
                elif "avg" in rec:
                    row["value"] = rec["avg"]
                else:
                    continue
                snap[str(rec.get("name"))] = row
            elif kind == "event":
                name = str(rec.get("name"))
                events[name] = events.get(name, 0) + 1
            elif kind == "meta":
                run = rec.get("run")
        with self._lock:
            self._snapshot.update(snap)
            for name, n in events.items():
                self._event_counts[name] = (
                    self._event_counts.get(name, 0) + n)
            self._meta["step"] = max(int(self._meta.get("step", 0)), step)
            self._meta["flushes"] = int(self._meta.get("flushes", 0)) + 1
            if run and not self._meta.get("run"):
                self._meta["run"] = run

    def render(self) -> str:
        with self._lock:
            return render_openmetrics(dict(self._snapshot),
                                      dict(self._meta),
                                      dict(self._event_counts))

    def render_json(self) -> str:
        with self._lock:
            return json.dumps({"meta": self._meta,
                               "metrics": self._snapshot,
                               "events": self._event_counts})

    # -- the server ----------------------------------------------------------
    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        from http.server import BaseHTTPRequestHandler, HTTPServer
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 - http.server API
                if self.path.split("?")[0] in ("/", "/metrics"):
                    body = exporter.render().encode()
                    ctype = ("text/plain; version=0.0.4; "
                             "charset=utf-8")
                elif self.path.split("?")[0] == "/json":
                    body = exporter.render_json().encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes never hit the run log
                pass

        self._server = HTTPServer((self._host, self._requested_port),
                                  _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="apex-tpu-metrics",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        srv, self._server = self._server, None
        thr, self._thread = self._thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thr is not None:
            thr.join(timeout=5.0)

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the process default (what Registry.flush consults)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[MetricsExporter] = None


def install(exp: Optional[MetricsExporter]) -> Optional[MetricsExporter]:
    """Install ``exp`` as the process default; returns the previous."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, exp
    return prev


def get_exporter() -> Optional[MetricsExporter]:
    return _DEFAULT


def maybe_start(*, run_id: Optional[str] = None
                ) -> Optional[MetricsExporter]:
    """Arm the process default when :data:`ENV_PORT` names a port.
    Idempotent: an already-installed exporter is returned as-is (its
    run identity refreshed).  Returns None — allocating nothing — when
    the env leaves the export off, the disabled-mode contract."""
    global _DEFAULT
    if _DEFAULT is not None:
        if run_id:
            _DEFAULT.set_meta(run=run_id)
        return _DEFAULT
    port = env_port()
    if port is None:
        return None
    _DEFAULT = MetricsExporter(port=port, run_id=run_id).start()
    return _DEFAULT


def shutdown() -> None:
    """Close and uninstall the process default (test/exit hygiene)."""
    global _DEFAULT
    exp, _DEFAULT = _DEFAULT, None
    if exp is not None:
        exp.close()
