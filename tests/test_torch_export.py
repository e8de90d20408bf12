"""The port's live OpenMetrics export against the JAX package's.

One snapshot (gauges, counters, a histogram, event counts, run identity)
renders to the same OpenMetrics text through both packages'
``render_openmetrics``, and the same flush records observed by both
packages' ``MetricsExporter`` render the same text.  One live scrape of
the port's endpoint on 127.0.0.1 (an OS-assigned port, no proxy) returns
the last flush window the JSONL recorded.  ``APEX_TPU_METRICS_PORT``
arms ``maybe_start`` (set only through ``monkeypatch``), which is
idempotent; ``shutdown`` stops it; without the variable nothing starts.
Every test shuts the exporter down and restores the defaults.
"""
import json
import urllib.error
import urllib.request

import pytest

from apex_tpu.telemetry import export as jax_export

from apex_tpu_torch.telemetry import export as port_export
from apex_tpu_torch.telemetry import registry as port_registry

_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    monkeypatch.delenv(port_export.ENV_PORT, raising=False)
    prev = port_export.install(None)
    yield
    port_export.shutdown()
    port_export.install(prev)


def _get(url):
    with _NO_PROXY.open(url, timeout=5) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def test_render_openmetrics_matches_jax():
    snap = {
        "loss": {"type": "gauge", "value": 1.5},
        "examples": {"type": "counter", "value": 32},
        "serve.p99_ms": {"type": "gauge", "value": 3.25},
        "acc": {"type": "meter", "value": 0.5, "avg": 0.25},
        "step_time_ms": {"type": "histogram",
                         "stats": {"count": 2, "sum": 10.0, "min": 4.0,
                                   "max": 6.0, "mean": 5.0}},
    }
    meta = {"run": 'r"1', "step": 8, "flushes": 4}
    events = {"resumed": 2, "serve.shed": 1}
    got = port_export.render_openmetrics(snap, meta, events)
    assert got == jax_export.render_openmetrics(snap, meta, events)
    assert got.endswith("# EOF\n")
    assert port_export.ENV_PORT == jax_export.ENV_PORT


def test_observed_flush_renders_like_jax():
    recs = [{"kind": "meta", "ts": "t", "fields": {"schema": 1}},
            {"kind": "metric", "ts": "t", "step": 3, "name": "loss",
             "type": "gauge", "value": 0.5},
            {"kind": "metric", "ts": "t", "step": 3, "name": "n",
             "type": "counter", "value": 7.0},
            {"kind": "event", "ts": "t", "step": 3, "name": "serve.admit",
             "fields": {"rid": "a"}}]

    class _Reg:
        run_id = "run-x"
        _step = 3

    pe = port_export.MetricsExporter(port=0, run_id="run-x")
    je = jax_export.MetricsExporter(port=0, run_id="run-x")
    for e in (pe, je):
        e.observe_flush(_Reg(), recs)
        e.observe_flush(_Reg(), recs)
    assert pe.render() == je.render()
    assert json.loads(pe.render_json()) == json.loads(je.render_json())


def test_live_scrape_is_the_last_flush(tmp_path):
    path = tmp_path / "t.jsonl"
    with port_export.MetricsExporter(port=0, run_id="scrape") as exp:
        assert exp.url.startswith("http://127.0.0.1:")
        reg = port_registry.Registry(
            sink=port_registry.JsonlSink(str(path)), flush_interval=2,
            rank0_only=False, run_id="scrape", memory=False, goodput=False,
            exporter=exp)
        for i in range(4):
            with reg.step():
                reg.gauge("loss").set(2.0 - 0.25 * i)
                reg.counter("examples").add(8)
        ctype, body = _get(exp.url)
        reg.close()
        with pytest.raises(urllib.error.HTTPError):
            _get(exp.url.replace("/metrics", "/nope"))
    assert ctype.startswith("text/plain")
    samples = dict(line.rsplit(" ", 1) for line in body.splitlines()
                   if line and not line.startswith("#"))
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    last = [r for r in recs if r.get("name") == "loss"][-1]
    assert float(samples["apex_tpu_loss"]) == last["value"] == 1.25
    assert samples["apex_tpu_examples_total"] == "32"
    assert samples['apex_tpu_build_info{run="scrape"}'] == "1"


def test_env_gate_and_idempotent_start(monkeypatch):
    assert port_export.maybe_start() is None
    assert port_export.get_exporter() is None
    for raw, want in (("", None), ("x", None), ("-3", None), ("0", 0),
                      (" 8123 ", 8123)):
        monkeypatch.setenv(port_export.ENV_PORT, raw)
        assert port_export.env_port() == want == jax_export.env_port()
    monkeypatch.setenv(port_export.ENV_PORT, "0")
    exp = port_export.maybe_start(run_id="r")
    assert exp is not None and exp.port > 0
    assert port_export.maybe_start(run_id="r") is exp
    assert port_export.get_exporter() is exp
    port_export.shutdown()
    assert port_export.get_exporter() is None
