"""The port's goodput ledger against the JAX package's.

The same synthetic spans and events (steps, a compile inside a step,
checkpoint and data waits, background spans that must not charge the
wall, a rollback with its replayed steps, a resume, a reshard, a measured
exposed-comm decomposition, a pipeline bubble) go into a JAX
``GoodputLedger`` and the port's, both with the same start; their
snapshots at the same instant give the same exact class partition, and
the JAX ``goodput_violations`` accepts the port's document and its
``GOODPUT.json``.  A ledger attached to the port's tracer takes spans as
they complete; installed, it exports its gauges at each ``Registry``
flush; ``summarize_records`` and the CLI render both forms.  Every test
restores the process defaults it sets.
"""
import json

import pytest

from apex_tpu.telemetry import goodput as jax_goodput

from apex_tpu_torch.telemetry import events as port_events
from apex_tpu_torch.telemetry import goodput as port_goodput
from apex_tpu_torch.telemetry import registry as port_registry
from apex_tpu_torch.telemetry import trace as port_trace

MS = 1000.0


@pytest.fixture(autouse=True)
def _defaults():
    saved = (port_goodput.install(None), port_trace.set_tracer(None),
             port_events.set_default(None))
    yield
    port_goodput.install(saved[0])
    port_trace.set_tracer(saved[1])
    port_events.set_default(saved[2])


def _script(led, t0, scenario):
    s = led.note_span
    s("train.step", t0 + 10 * MS, 20 * MS, step=0)
    s("compile.backend_compile", t0 + 20 * MS, 5 * MS)
    s("ckpt.exposed", t0 + 40 * MS, 5 * MS)
    s("data.fetch", t0 + 50 * MS, 10 * MS)
    s("loader.fill", t0 + 50 * MS, 30 * MS)
    s("ckpt.write", t0 + 55 * MS, 30 * MS)
    s("bench.headline", t0 + 70 * MS, 10 * MS)
    s("train.step", t0 + 100 * MS, 10 * MS, step=1)
    s("train.step", t0 + 112 * MS, 10 * MS, step=2)
    if scenario == "rollback":
        led.note_event("rollback", step=2)
        s("guard.backoff", t0 + 123 * MS, 2 * MS)
        s("ckpt.restore", t0 + 125 * MS, 3 * MS)
        s("train.step", t0 + 130 * MS, 10 * MS, step=1)   # replayed
        s("train.step", t0 + 141 * MS, 10 * MS, step=2)   # replayed
        s("train.step", t0 + 152 * MS, 10 * MS, step=3)
    elif scenario == "resume_reshard":
        led.note_event("resumed", step=0)
        led.note_event("elastic.reshard")
        s("elastic.reshard", t0 + 125 * MS, 4 * MS)
        s("elastic.replan", t0 + 127 * MS, 4 * MS)
        s("ckpt.restore", t0 + 132 * MS, 3 * MS)
    elif scenario == "carves":
        led.set_decomposition({"totals": {"exposed_comm_fraction": 0.1},
                               "steps": [{"step": 1, "devices": {
                                   "d0": {"busy_ms": 10.0,
                                          "exposed_comm_ms": 4.0}}}]})
        led.set_pipeline_bubble(0.25)
    led.note_event("fault_injected")
    led.note_event("unrelated.event")


@pytest.mark.parametrize("scenario", ["plain", "rollback", "resume_reshard",
                                      "carves"])
def test_partition_matches_jax(scenario):
    jl, pl = jax_goodput.GoodputLedger(), port_goodput.GoodputLedger()
    pl.t0_us = jl.t0_us
    for led in (jl, pl):
        _script(led, jl.t0_us, scenario)
    now = jl.t0_us + 200 * MS
    jd, pd = jl.snapshot(now_us=now), pl.snapshot(now_us=now)
    strip = lambda d: {k: v for k, v in d.items() if k != "ts"}  # noqa: E731
    assert strip(pd) == strip(jd)
    assert jax_goodput.goodput_violations(pd) == []
    assert port_goodput.goodput_violations(pd) == []
    total = sum(r["ms"] for r in pd["classes"].values())
    assert abs(total - pd["wall_ms"]) <= 1e-3
    if scenario == "plain":
        c = {k: v["ms"] for k, v in pd["classes"].items()}
        assert c["recompile"] == pytest.approx(5.0)
        assert c["productive"] == pytest.approx(35.0)
        assert c["idle"] == pytest.approx(145.0)


def test_constants_and_validators_match_jax():
    assert port_goodput.CLASSES == jax_goodput.CLASSES
    assert port_goodput.BADPUT_CLASSES == jax_goodput.BADPUT_CLASSES
    assert port_goodput.FAULT_BADPUT == jax_goodput.FAULT_BADPUT
    assert port_goodput.SPAN_CLASSES == jax_goodput.SPAN_CLASSES
    assert port_goodput.ARTIFACT_NAME == jax_goodput.ARTIFACT_NAME
    led = port_goodput.GoodputLedger()
    good = led.snapshot(now_us=led.t0_us + 10 * MS)
    for bad in ({}, [], dict(good, kind="x"), dict(good, wall_ms=5.0),
                dict(good, counts={"rollbacks": 1})):
        assert (port_goodput.goodput_violations(bad)
                == jax_goodput.goodput_violations(bad))
        assert port_goodput.goodput_violations(bad)
    off = port_goodput.GoodputLedger(enabled=False)
    off.note_span("train.step", off.t0_us, 5.0, step=0)
    assert off._n_intervals == 0


def test_attached_ledger_exports_through_the_registry(tmp_path, capsys):
    """Spans stream from the port's tracer into the ledger; the installed
    ledger's gauges land in the registry's flush; GOODPUT.json and the
    JSONL both render through the CLI."""
    tr = port_trace.Tracer(enabled=True)
    led = port_goodput.GoodputLedger()
    led.attach(tr)
    port_goodput.install(led)
    port_trace.set_tracer(tr)
    sink = port_registry.JsonlSink(str(tmp_path / "run.jsonl"))
    reg = port_registry.Registry(sink=sink, flush_interval=2,
                                 rank0_only=False, memory=False,
                                 exporter=False)
    for _ in range(4):
        with port_trace.span("data.fetch"):
            pass
        with reg.step():
            sum(range(1000))
    reg.close()
    led.detach(tr)
    assert tr.ledger is None
    doc = led.snapshot()
    assert doc["steps"] == 4 and doc["classes"]["productive"]["ms"] > 0
    path = led.write(directory=str(tmp_path))
    assert path.endswith("GOODPUT.json")
    assert jax_goodput.goodput_violations(json.load(open(path))) == []
    assert led.write() is None
    recs = [json.loads(x) for x in open(tmp_path / "run.jsonl")]
    names = {r.get("name") for r in recs}
    assert {"goodput.fraction", "badput.idle_ms"} <= names
    summ = port_goodput.summarize_records(recs)
    assert summ == jax_goodput.summarize_records(recs)
    assert port_goodput.summarize_records([]) is None
    assert port_goodput.cli([path]) == 0
    assert "goodput ledger" in capsys.readouterr().out
    assert port_goodput.cli([str(tmp_path / "run.jsonl"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["source"] == "jsonl"
    assert port_goodput.cli([str(tmp_path / "nope")]) == 1
    assert (port_goodput.format_ledger(doc)
            == jax_goodput.format_ledger(doc))
