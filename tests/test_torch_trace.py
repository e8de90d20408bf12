"""The port's span tracer, flight recorder and slow-step sentinel against
the JAX package's.

The same scripted spans (nested, on two threads, with counters and
instants) go through the port's ``Tracer``; its Chrome file, read by the
JAX ``load_chrome``, gives the same ``span_summary`` as the port's own
reader, and the JAX tracer's file read by the port's reader does too.
Flight dumps (a rollback reason, the sentinel's slow-step dump) pass the
JAX ``dump_violations``.  The sentinel fires on the same step in both
packages for the same step times, and its one-shot ``torch.profiler``
capture (on the CPU here) lands as a Chrome trace the port's
``load_chrome`` reads; a capture holding a card's device lanes is
decomposed into a ``slow_step_timeline`` dump the JAX ``dump_violations``
accepts, its decomposition fed to the tracer's goodput ledger.  A
disabled tracer hands out the shared null span and records nothing.

Port-only: with no profiler session and no tracer, ``span`` is the null
span and 10,000 of them allocate nothing; under ``torch.profiler`` every
span (module-level, a disabled tracer's, ``traced``) leaves a
``user_annotation`` row of its name; with a tracer installed a span is
both recorded and mirrored.  Every test restores the default tracer.
"""
import json
import threading

import pytest

from apex_tpu.telemetry import events as jax_events
from apex_tpu.telemetry import trace as jax_trace

from apex_tpu_torch.telemetry import events as port_events
from apex_tpu_torch.telemetry import registry as port_registry
from apex_tpu_torch.telemetry import trace as port_trace


@pytest.fixture(autouse=True)
def _defaults():
    saved = (jax_trace.set_tracer(None), port_trace.set_tracer(None),
             jax_events.set_default(None), port_events.set_default(None))
    yield
    jax_trace.set_tracer(saved[0])
    port_trace.set_tracer(saved[1])
    jax_events.set_default(saved[2])
    port_events.set_default(saved[3])


def _scripted(tr):
    """Nested spans on this thread and a worker, a post-hoc span, a
    counter sample and an instant."""
    with tr.span("outer", step=1):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    worker = threading.Thread(
        target=lambda: [tr.span("worker").__enter__().__exit__(None, None,
                                                               None)
                        for _ in range(3)], name="worker-thread")
    worker.start()
    worker.join()
    tr.add("loader.wait", 0.002, depth=3)
    tr.counter("device_mem", step=1, bytes_in_use=10.0, junk="drop")
    tr.instant("mark", why="test")


def _shape(rows):
    return [(r["name"], r["count"]) for r in rows]


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gzip"])
def test_chrome_file_reads_the_same_in_both_packages(tmp_path, gz):
    tr = port_trace.Tracer(enabled=True)
    _scripted(tr)
    path = tr.write(str(tmp_path / ("t.json.gz" if gz else "t.json")))
    mine = port_trace.load_chrome(path)
    theirs = jax_trace.load_chrome(path)
    assert [e["name"] for e in mine] == [e["name"] for e in theirs]
    assert port_trace.span_summary(mine) == jax_trace.span_summary(theirs)
    assert _shape(port_trace.span_summary(mine)) == _shape(
        jax_trace.span_summary(theirs))
    assert {r["name"] for r in port_trace.span_summary(mine)} == {
        "outer", "inner", "worker", "loader.wait"}
    # the JAX tracer's file through the port's reader
    jt = jax_trace.Tracer(enabled=True)
    _scripted(jt)
    jpath = jt.write(str(tmp_path / "jax.json"))
    assert _shape(port_trace.span_summary(port_trace.load_chrome(jpath))) \
        == _shape(jax_trace.span_summary(jax_trace.load_chrome(jpath)))
    assert (port_trace.format_span_summary(port_trace.span_summary(mine))
            == jax_trace.format_span_summary(jax_trace.span_summary(theirs)))


def test_streaming_array_and_torn_tail(tmp_path):
    events = [{"ph": "X", "name": f"s{i}", "ts": float(i), "dur": 0.5,
               "pid": 1, "tid": 1} for i in range(4)]
    text = "[\n" + "".join(json.dumps(e) + ",\n" for e in events) + '{"ph":'
    p = tmp_path / "stream.json"
    p.write_text(text)
    assert [e["name"] for e in port_trace.load_chrome(str(p))] == [
        e["name"] for e in jax_trace.load_chrome(str(p))]
    (tmp_path / "bad.json").write_text("not json")
    with pytest.raises(ValueError):
        port_trace.load_chrome(str(tmp_path / "bad.json"))


def test_flight_dump_passes_the_jax_schema(tmp_path):
    tr = port_trace.Tracer(enabled=True, ring=8, flight_dir=str(tmp_path))
    _scripted(tr)
    tr.note_event("rollback", step=3, fields={"why": "nan", "arr": object()})
    tr.note_flush(3, [{"name": "loss"}, {"name": "x"}])
    path = tr.recorder.dump("rollback", step=3, fields={"n": 1})
    doc = json.loads(open(path).read())
    assert jax_trace.dump_violations(doc) == []
    assert port_trace.dump_violations(doc) == []
    assert doc["n_entries"] == 8 and doc["total_recorded"] > 8
    assert {e["kind"] for e in doc["entries"]} <= set(jax_trace.ENTRY_KINDS)
    assert port_trace.Tracer(enabled=True).recorder.dump("x") is None
    bad = dict(doc, n_entries=1)
    assert port_trace.dump_violations(bad) == jax_trace.dump_violations(bad)


def test_disabled_tracer_is_the_null_span(monkeypatch):
    tr = port_trace.Tracer(enabled=False)
    assert tr.span("x") is port_trace.NULL_SPAN
    _scripted(tr)
    assert tr.n_spans == 0 and tr.recorder.total == 0
    assert port_trace.span("x") is port_trace.NULL_SPAN   # none installed

    @port_trace.traced("deco")
    def f(x):
        return x + 1
    assert f(1) == 2
    monkeypatch.setenv("APEX_TPU_TRACE", "off")
    assert port_trace.Tracer().enabled is False


def _sentinel_run(mod, emod, rmod, tmp_path, times, **kw):
    reg = rmod.Registry(sink=rmod.MemorySink(), rank0_only=False,
                        flush_interval=0, **({} if mod is jax_trace else
                                             dict(memory=False)))
    sent = mod.SlowStepSentinel(window=8, warmup=4, cooldown=2,
                                dump_dir=str(tmp_path), **kw)
    tr = mod.Tracer(enabled=True, sentinel=sent)
    prev = mod.set_tracer(tr)
    fires = []
    try:
        for i, t in enumerate(times):
            mod.note_step(i, t, registry=reg)
            fires.append(sent.fires)
    finally:
        mod.set_tracer(prev)
    reg.flush()
    return sent, fires, reg


def test_sentinel_fires_like_jax_and_dumps(tmp_path):
    times = [0.01, 0.0102, 0.0098, 0.0101, 0.01, 0.05, 0.0099, 0.0101,
             0.0499, 0.0100]
    js, jf, _ = _sentinel_run(jax_trace, jax_events, __import__(
        "apex_tpu.telemetry.registry", fromlist=["x"]), tmp_path / "j",
        times)
    ps, pf, reg = _sentinel_run(port_trace, port_events, port_registry,
                                tmp_path / "p", times)
    assert pf == jf and ps.fires == js.fires >= 1
    dumps = sorted((tmp_path / "p").glob("flight-slow_step-*.json"))
    assert len(dumps) == ps.fires
    for d in dumps:
        assert jax_trace.dump_violations(json.loads(d.read_text())) == []
    with pytest.raises(ValueError):
        port_trace.SlowStepSentinel(window=4, warmup=8)


def test_sentinel_capture_writes_a_torch_profiler_trace(tmp_path):
    times = [0.01] * 6 + [0.2] + [0.01] * 4
    sent, fires, _ = _sentinel_run(port_trace, port_events, port_registry,
                                   tmp_path, times,
                                   profile_dir=str(tmp_path / "prof"),
                                   profile_steps=2)
    assert sent.fires == 1 and sent.captures == 1
    assert not sent._capturing and len(sent.capture_paths) == 1
    assert port_trace.load_chrome(str(tmp_path / "prof")) is not None
    sent.stop_capture()                      # idempotent
    assert len(sent.capture_paths) == 1


def _card_capture_events():
    """What a capture of two steps on a card parses to: each step's
    range mirrored onto the stream, a GEMM and an NCCL kernel that
    outlasts it (partly exposed), and a 0.5 ms gap in the first step."""
    from apex_tpu_torch.pyprof import parse
    raw = []
    for s, t0 in enumerate((0.0, 2000.0)):
        raw += [
            {"ph": "X", "cat": "gpu_user_annotation", "name": "train.step",
             "pid": 0, "tid": 7, "ts": t0, "dur": 1500.0 - 500.0 * s,
             "args": {"External id": s}},
            {"ph": "X", "cat": "kernel", "name": "nvjet_tst_256x128_NNT",
             "pid": 0, "tid": 7, "ts": t0, "dur": 400.0,
             "args": {"device": 0}},
            {"ph": "X", "cat": "kernel",
             "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "pid": 0,
             "tid": 21, "ts": t0 + 300.0, "dur": 200.0,
             "args": {"device": 0}},
            {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x64_TNT",
             "pid": 0, "tid": 7, "ts": t0 + 1000.0 - 500.0 * s,
             "dur": 500.0, "args": {"device": 0}}]
    return parse.events_from_chrome(raw)


def test_sentinel_capture_dumps_its_timeline(tmp_path, monkeypatch):
    """A closing capture is decomposed (``timeline.summarize``) into a
    ``slow_step_timeline`` flight dump that the JAX ``dump_violations``
    accepts, and the tracer's goodput ledger takes the measured
    decomposition."""
    from apex_tpu_torch.telemetry import goodput as port_goodput
    from apex_tpu_torch.telemetry import timeline as port_timeline
    events = _card_capture_events()
    monkeypatch.setattr(port_timeline, "load_events", lambda path: events)
    times = [0.01] * 6 + [0.2] + [0.01] * 4
    led = port_goodput.GoodputLedger()
    tr = port_trace.Tracer(enabled=True, flight_dir=str(tmp_path))
    led.attach(tr)
    sent = port_trace.SlowStepSentinel(
        window=8, warmup=4, z_threshold=3.0, min_slowdown=1.5,
        cooldown=2, profile_dir=str(tmp_path / "prof"), profile_steps=2)
    reg = port_registry.Registry(sink=port_registry.MemorySink(),
                                 flush_interval=0, rank0_only=False,
                                 memory=False, goodput=False, exporter=False)
    for i, t in enumerate(times):
        sent.observe(i, t, tracer=tr, registry=reg)
    assert sent.fires == 1 and len(sent.capture_paths) == 1
    dumps = sorted(tmp_path.glob("flight-slow_step_timeline-*.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert jax_trace.dump_violations(doc) == []
    decomp = doc["timeline"]["decomposition"]
    assert decomp == port_timeline.decompose(events)
    assert [s["devices"]["GPU:0"]["idle_ms"] for s in decomp["steps"]] == \
        [0.5, 0.0]
    assert decomp["totals"]["exposed_comm_ms"] == 0.2
    assert doc["fields"]["exposed_comm_ms"] == 0.2
    assert "device timeline decomposition" in doc["timeline"]["table"]
    assert led._exposed_frac == {0: 0.1, 1: 0.1}


def test_trace_cli(tmp_path, capsys):
    tr = port_trace.Tracer(enabled=True)
    _scripted(tr)
    path = tr.write(str(tmp_path / "t.json"))
    assert port_trace.cli([path, "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert "span timeline summary" in out and "more names" in out
    empty = port_trace.Tracer(enabled=True).write(str(tmp_path / "e.json"))
    assert port_trace.cli([empty]) == 1


def _traced_alloc(loop, n):
    """Bytes a loop leaves allocated, and its peak, under tracemalloc."""
    import tracemalloc
    loop(10)
    tracemalloc.start()
    try:
        loop(10)
        tracemalloc.reset_peak()
        c0, _ = tracemalloc.get_traced_memory()
        loop(n)
        c1, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return c1 - c0, peak - c0


def test_span_with_no_profiler_and_no_tracer_is_null_and_allocates_nothing():
    assert port_trace.span("model.attention") is port_trace.NULL_SPAN
    assert port_trace.profiler_range("x") is port_trace.NULL_SPAN
    assert port_trace.Tracer(enabled=False).span("x") is \
        port_trace.NULL_SPAN

    def spans(n):
        for _ in range(n):
            with port_trace.span("model.attention"):
                pass

    def null(n):
        for _ in range(n):
            with port_trace.NULL_SPAN:
                pass
    # 10,000 spans allocate no more than the same loop over the singleton
    assert _traced_alloc(spans, 10_000) == _traced_alloc(null, 10_000)


def _annotations(prof):
    return [e.name for e in prof.events()
            if e.device_type.name == "CPU" and e.name.startswith("t.")]


def test_span_under_the_profiler_leaves_a_user_annotation_row(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    @port_trace.traced("t.deco")
    def f(x):
        return x + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with port_trace.span("t.outer", step=3):
            with port_trace.Tracer(enabled=False).span("t.inner"):
                torch.ones(4).sum()
            f(torch.ones(2))
    assert sorted(_annotations(prof)) == ["t.deco", "t.inner", "t.outer"]
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        rows = [e for e in json.load(fh)["traceEvents"]
                if e.get("name", "").startswith("t.")]
    assert {e["cat"] for e in rows} == {"user_annotation"}
    # outside a session the same calls are the null span again
    assert port_trace.span("t.outer") is port_trace.NULL_SPAN


def test_span_with_a_tracer_records_and_mirrors_into_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    tr = port_trace.Tracer(enabled=True)
    port_trace.set_tracer(tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with port_trace.span("t.step", step=1):
            with tr.span("t.inner"):
                pass
    with port_trace.span("t.after"):       # no session: the tracer alone
        pass
    assert sorted(_annotations(prof)) == ["t.inner", "t.step"]
    doc = tr.export()
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert set(spans) == {"t.step", "t.inner", "t.after"}
    assert spans["t.step"]["args"] == {"step": 1}
    assert spans["t.step"]["ts"] <= spans["t.inner"]["ts"]
