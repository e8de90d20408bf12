"""The port's fleet view (``apex_tpu_torch.telemetry.fleet``) against the
JAX package's.

The test writes per-host run dirs with the port's own writers: a
``GOODPUT.json`` from the port's ledger, a JSONL stream of step-time
histograms (one host straggling), flight dumps from the port's recorder,
a host span trace from the port's tracer, and an empty dir (a host that
died before writing anything).  ``build_fleet`` of both packages over the
same dirs gives the same ``FLEET.json`` apart from its ``ts``, exactly,
and the same merged ``FLEET_TRACE.json`` apart from the Kineto ``cat``
the port's parser keeps; the port's document passes the JAX
``fleet_violations``; a host whose goodput partition is torn fails both
merges; the CLI writes and re-reads the artifact.
"""
import calendar
import json
import os
import time

import pytest

from apex_tpu.telemetry import fleet as jax_fleet

from apex_tpu_torch.telemetry import fleet as port_fleet
from apex_tpu_torch.telemetry import goodput as port_goodput
from apex_tpu_torch.telemetry import trace as port_trace

EPOCH = calendar.timegm(time.strptime("2026-08-07T10:00:00Z",
                                      "%Y-%m-%dT%H:%M:%SZ"))


def _ts(epoch):
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch))


def _goodput_doc(end_epoch, steps, stall_us=0.0):
    """The port ledger's document over ``steps`` 10 ms step spans (and a
    data stall), as of ``end_epoch``."""
    led = port_goodput.GoodputLedger()
    led.t0_us = 0.0
    for s in range(steps):
        led.note_span("train.step", 12_000.0 * s, 10_000.0, step=s)
    if stall_us:
        led.note_span("data.fetch", 12_000.0 * steps, stall_us)
    doc = led.snapshot(now_us=12_000.0 * steps + stall_us + 500.0,
                       status="completed")
    doc["ts"] = _ts(end_epoch)
    assert port_goodput.goodput_violations(doc) == []
    return doc


def _hist(step, mean_ms, epoch):
    return {"kind": "metric", "ts": _ts(epoch), "step": int(step),
            "name": "step_time_ms", "type": "histogram",
            "stats": {"count": 1, "sum": float(mean_ms),
                      "min": float(mean_ms), "max": float(mean_ms),
                      "mean": float(mean_ms)}}


def _hosts(tmp_path):
    dirs = []
    for h, slow in (("h0", 1.0), ("h1", 1.0), ("h2", 1.0), ("h3", 3.0)):
        d = tmp_path / h
        d.mkdir()
        (d / "GOODPUT.json").write_text(json.dumps(
            _goodput_doc(EPOCH + 60, 5, stall_us=2000.0 * slow)))
        recs = [_hist(s, 10.0 * (slow if s >= 2 else 1.0),
                      EPOCH + s + (0.4 if h == "h3" else 0.0))
                for s in range(5)]
        recs.append({"kind": "metric", "ts": _ts(EPOCH + 5), "step": 5,
                     "name": "loss.plateau_windows", "type": "gauge",
                     "value": 2.0})
        (d / "telemetry.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in recs))
        dirs.append(str(d))
    rec = port_trace.FlightRecorder(capacity=8, directory=dirs[3])
    rec.record({"kind": "event", "name": "x", "t": 0.0})
    rec.dump("rollback", step=3)
    tr = port_trace.Tracer(enabled=True)
    with tr.span("train.step", step=0):
        with tr.span("data.fetch"):
            pass
    tr.write(os.path.join(dirs[1], "host.trace.json"))
    empty = tmp_path / "h4"
    empty.mkdir()
    dirs.append(str(empty))
    return dirs


def _drop_ts(doc):
    return {k: v for k, v in doc.items() if k != "ts"}


def test_build_fleet_equals_jax(tmp_path):
    dirs = _hosts(tmp_path)
    pdoc, ptl = port_fleet.build_fleet(dirs, z_threshold=2.0)
    jdoc, jtl = jax_fleet.build_fleet(dirs, z_threshold=2.0)
    assert _drop_ts(pdoc) == _drop_ts(jdoc)
    assert pdoc["n_hosts"] == 5
    assert pdoc["stragglers"]["named"] == "h3"
    assert pdoc["per_host"]["h3"]["flight_dumps"] == 1
    assert pdoc["per_host"]["h4"]["goodput"] is None
    assert pdoc["control"]["actions_fired"] == 0     # no run controller
    # the merged Chrome docs: the port's parse keeps each span's ``cat``
    strip = [{k: v for k, v in e.items() if k != "cat"}
             for e in ptl["traceEvents"]]
    jstrip = [{k: v for k, v in e.items() if k != "cat"}
              for e in jtl["traceEvents"]]
    assert strip == jstrip and strip


def test_port_fleet_passes_the_jax_schema(tmp_path):
    doc, timeline = port_fleet.build_fleet(_hosts(tmp_path))
    assert jax_fleet.fleet_violations(doc) == []
    assert port_fleet.fleet_violations(doc) == []
    (tmp_path / "out").mkdir()
    path = port_fleet.write_fleet(doc, str(tmp_path / "out"), timeline)
    assert os.path.exists(os.path.join(tmp_path, "out",
                                       port_fleet.TIMELINE_NAME))
    assert jax_fleet.load_artifact(path) == port_fleet.load_artifact(path)
    assert port_fleet.format_fleet(doc) == jax_fleet.format_fleet(doc)


def test_a_torn_partition_fails_both_merges(tmp_path):
    dirs = _hosts(tmp_path)
    bad = json.loads(open(os.path.join(dirs[0], "GOODPUT.json")).read())
    bad["classes"]["productive"]["ms"] += 5.0
    open(os.path.join(dirs[0], "GOODPUT.json"), "w").write(json.dumps(bad))
    for mod in (port_fleet, jax_fleet):
        with pytest.raises(ValueError):
            mod.build_fleet(dirs)


def test_fleet_cli_writes_and_rereads(tmp_path, capsys):
    dirs = _hosts(tmp_path)
    out = str(tmp_path / "fleet_out")
    os.makedirs(out)
    assert port_fleet.cli(dirs + ["--out", out]) == 0
    text = capsys.readouterr().out
    assert "fleet view  (5 hosts" in text and "wrote" in text
    assert port_fleet.cli([os.path.join(out, port_fleet.ARTIFACT_NAME),
                           "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert jax_fleet.fleet_violations(doc) == []
    # bad input (a torn host partition) exits 1
    bad = json.loads(open(os.path.join(dirs[0], "GOODPUT.json")).read())
    bad["classes"]["idle"]["ms"] += 5.0
    open(os.path.join(dirs[0], "GOODPUT.json"), "w").write(json.dumps(bad))
    assert port_fleet.cli(dirs) == 1
