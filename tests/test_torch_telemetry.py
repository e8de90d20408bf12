"""The port's telemetry registry, events, report and logging against the
JAX package's.

The same scripted sequence of metric updates and events goes through the
JAX ``Registry`` and the port's, each into a ``MemorySink``: the records
are equal once their timestamps are stripped, and ``SCHEMA`` is the same
table.  The JAX ``record_violations`` accepts every port record.  Amp
scaler transitions (a forced-inf step, then a scale-window growth) give
the same event kinds through both packages' ``observe_scaler``.
``report.summarize`` gives the same summary for the same records.  A
flush resolves its pending tensors with one host read a device (counted
through ``registry._to_host`` over meta tensors, which stand in for a
device here); disabled mode and the steps between flushes read nothing.
``utils.logging`` keeps the JAX package's names and rank-0 gating.
Every test restores the process defaults it sets.
"""
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.amp import scaler as jax_scaler
from apex_tpu.telemetry import events as jax_events
from apex_tpu.telemetry import registry as jax_registry
from apex_tpu.telemetry import report as jax_report
from apex_tpu.telemetry import trace as jax_trace

import apex_tpu_torch.telemetry as tel
from apex_tpu_torch.amp import scaler as port_scaler
from apex_tpu_torch.telemetry import events as port_events
from apex_tpu_torch.telemetry import registry as port_registry
from apex_tpu_torch.telemetry import report as port_report
from apex_tpu_torch.telemetry import trace as port_trace
from apex_tpu_torch.utils import logging as port_logging


@pytest.fixture(autouse=True)
def _defaults():
    """No default registry or tracer of either package leaks in or out."""
    saved = (jax_events.set_default(None), port_events.set_default(None),
             jax_trace.set_tracer(None), port_trace.set_tracer(None))
    yield
    jax_events.set_default(saved[0])
    port_events.set_default(saved[1])
    jax_trace.set_tracer(saved[2])
    port_trace.set_tracer(saved[3])


def _strip(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def _script(mod, value):
    """One scripted run against registry module ``mod``; ``value(x)``
    makes a device value of the package (a jax or torch scalar)."""
    sink = mod.MemorySink()
    reg = mod.Registry(sink=sink, flush_interval=2, rank0_only=False,
                       run_id="script", memory=False, goodput=False,
                       exporter=False)
    for i in range(5):
        with reg.step():
            reg.gauge("loss").set(value(1.0 / (i + 1)))
            reg.counter("examples").add(8)
            reg.counter("tokens").add(value(16.0), n=2)
            reg.histogram("lat_ms").observe(float(i))
            reg.meter("acc").update(0.5 + 0.1 * i)
            if i == 3:
                reg.event("custom", step_tag=i, value=value(2.5),
                          note="x", flag=True)
    reg.close()
    # step_time_ms is a host clock: keep its shape, drop its numbers
    out = []
    for r in sink.records:
        if r.get("name") == "step_time_ms":
            r = dict(r, stats={k: 0 for k in r["stats"]})
        out.append(r)
    return out


def test_registry_records_match_jax_and_schema_is_the_same():
    jrec = _script(jax_registry, lambda x: jnp.asarray(x, jnp.float32))
    prec = _script(port_registry, lambda x: torch.tensor(x))
    assert _strip(prec) == _strip(jrec)
    assert jax_registry.records_violations(prec) == []
    assert port_registry.SCHEMA.keys() == jax_registry.SCHEMA.keys()
    for kind in jax_registry.SCHEMA:
        for part in range(2):
            assert (port_registry.SCHEMA[kind][part].keys()
                    == jax_registry.SCHEMA[kind][part].keys()), kind
    assert port_registry.METRIC_TYPES == jax_registry.METRIC_TYPES
    # the validators agree on bad records too
    for bad in ({"kind": "metric"}, {"kind": "nope"}, [],
                {"kind": "event", "ts": "t", "step": 1, "name": "e",
                 "fields": {"x": [1]}}):
        assert (port_registry.record_violations(bad)
                == jax_registry.record_violations(bad))


def test_jsonl_sink_round_trip_and_report_match_jax(tmp_path):
    recs = _script(port_registry, lambda x: torch.tensor(x))
    path = tmp_path / "run.jsonl"
    sink = port_registry.JsonlSink(str(path))
    sink.write(recs)
    sink.close()
    port_loaded = port_report.load_records(str(path), validate=True)
    jax_loaded = jax_report.load_records(str(path), validate=True)
    assert port_loaded == jax_loaded == recs
    assert port_report.summarize(recs) == jax_report.summarize(recs)
    assert (port_report.format_summary(port_report.summarize(recs))
            == jax_report.format_summary(jax_report.summarize(recs)))
    with pytest.raises(ValueError):
        port_registry.JsonlSink(str(tmp_path / "bad.jsonl")).write(
            [{"kind": "metric"}])


class _Meta:
    """Meta tensors stand in for a device: ``_to_host`` is the one place
    a flush copies device values, so counting its calls counts reads."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(port_registry, "_to_host", self._to_host)

    def _to_host(self, flat):
        assert flat.device.type == "meta"
        self.calls.append(flat.numel())
        return [float(i) for i in range(flat.numel())]


@pytest.mark.parametrize("interval", [1, 3])
def test_one_device_read_per_flush_none_between(monkeypatch, interval):
    meta = _Meta(monkeypatch)
    sink = port_registry.MemorySink()
    reg = port_registry.Registry(sink=sink, flush_interval=interval,
                                 rank0_only=False, memory=False,
                                 goodput=False, exporter=False)
    for i in range(6):
        with reg.step():
            reg.gauge("loss").set(torch.empty((), device="meta"))
            reg.gauge("scale").set(torch.empty((), dtype=torch.int32,
                                               device="meta"))
            reg.counter("tok").add(torch.empty((), device="meta"))
            reg.histogram("h").observe(torch.empty((), device="meta"))
            reg.event("e", v=torch.empty((), device="meta"))
            reg.gauge("host").set(1.0)
        # no read inside a flush interval
        assert reg.device_reads == len(meta.calls) == (i + 1) // interval
    # every read took all the flush's pending device values at once: the
    # two gauges' last values, and each step's counter, histogram and
    # event values
    assert meta.calls == [2 + 3 * interval] * (6 // interval)
    reg.flush()                      # nothing pending: no read
    assert reg.device_reads == 6 // interval
    assert port_registry.records_violations(sink.records) == []


def test_disabled_registry_records_and_reads_nothing(monkeypatch):
    meta = _Meta(monkeypatch)
    sink = port_registry.MemorySink()
    reg = port_registry.Registry(sink=sink, enabled=False)
    assert reg.gauge("x") is port_registry.NULL_METRIC
    for _ in range(4):
        with reg.step():
            reg.gauge("loss").set(torch.empty((), device="meta"))
            reg.counter("c").add(torch.empty((), device="meta"))
            reg.event("e", v=torch.empty((), device="meta"))
    assert reg.flush() == [] and sink.records == []
    assert meta.calls == [] and reg.device_reads == 0
    assert reg.read() == {}
    monkeypatch.setenv("APEX_TPU_TELEMETRY", "0")
    assert port_registry.Registry().enabled is False


def _scaler_run(mod, make, window):
    """A forced-inf step, two finite steps (the window grows the scale),
    then a steady step, through package ``mod``'s ``update`` and its
    events' ``observe_scaler``; returns the kinds and the records."""
    rmod, emod = make
    sink = rmod.MemorySink()
    reg = rmod.Registry(sink=sink, rank0_only=False, flush_interval=0,
                        memory=False, goodput=False, exporter=False)
    st = mod.init(init_scale=2.0 ** 10, scale_window=window,
                  **({} if mod is jax_scaler else {"device": "cpu"}))
    kinds = []
    for finite in (False, True, True, True):
        new = mod.update(st, jnp.asarray(finite) if mod is jax_scaler
                         else torch.tensor(finite))
        kinds.append(emod.observe_scaler(reg, st, new))
        st = new
    reg.flush()
    return kinds, [r for r in sink.records if r["kind"] != "meta"]


def test_scaler_transitions_match_jax():
    jk, jr = _scaler_run(jax_scaler, (jax_registry, jax_events), 2)
    pk, pr = _scaler_run(port_scaler, (port_registry, port_events), 2)
    assert pk == jk == ["overflow", "steady", "grew", "steady"]
    assert _strip(pr) == _strip(jr)
    assert [r["name"] for r in pr if r["kind"] == "event"] == [
        "amp.overflow", "amp.loss_scale_doubled"]
    # disabled: nothing read, None back
    st = port_scaler.init(device="cpu")
    off = port_registry.Registry(enabled=False)
    assert port_events.observe_scaler(off, st, st) is None
    assert port_events.observe_scaler(None, st, st) is None


def test_library_hooks_match_jax():
    """The loader, shard, checkpoint and collective hooks land the same
    records through each package's default registry, and do nothing
    without one."""
    def run(rmod, emod):
        sink = rmod.MemorySink()
        reg = rmod.Registry(sink=sink, rank0_only=False, flush_interval=0,
                            memory=False, goodput=False, exporter=False)
        for hook in (lambda: emod.record_loader(3, 0.002),
                     lambda: emod.record_loader_retry(4, 1, 0.5, 1.0),
                     lambda: emod.record_shard_checksum("s0.npz", 7),
                     lambda: emod.record_ckpt(0.25, 1024),
                     lambda: emod.record_ckpt_exposed(0.01),
                     lambda: emod.record_update_sharding(4096, 2),
                     lambda: emod.record_collective("dp", 256, 3, 0.001)):
            hook()                         # no default: a no-op
        prev = emod.set_default(reg)
        try:
            assert emod.active() and emod.get_default() is reg
            emod.record_loader(3, 0.002)
            emod.record_loader(None, 0.004)
            emod.record_loader_retry(4, 1, 0.5, 1.0)
            emod.record_shard_checksum("s0.npz", 7)
            emod.record_ckpt(0.25, 1024)
            emod.record_ckpt_exposed(0.01)
            emod.record_update_sharding(4096, 2)
            emod.record_collective("dp", 256, 3, 0.001, wire_bytes=128,
                                   dtype="bfloat16", scheme="bf16")
        finally:
            emod.set_default(prev)
        reg.flush()
        return _strip(sink.records)

    assert run(port_registry, port_events) == run(jax_registry, jax_events)
    assert port_events.install_compile_listener() is False


def test_package_exports_the_jax_names_minus_the_deferred():
    """Nothing is deferred any more: the port exports every JAX name
    (``timeline``, ``fleet`` and memory's static half included), and the
    module list documents each."""
    import apex_tpu.telemetry as jax_tel
    assert set(tel.__all__) == set(jax_tel.__all__)
    for name in tel.__all__:
        assert getattr(tel, name) is not None, name
    for name in ("timeline", "fleet", "attrib", "memory_table"):
        assert name in tel.__doc__, name


def test_logging_names_and_rank0_gating(capsys):
    assert port_logging.rank() == 0 and port_logging.is_rank0()
    port_logging.maybe_print("hello")
    assert capsys.readouterr().out == "hello\n"
    key = "test_torch_telemetry.once"
    assert port_logging.warn_once(key, "careful") is True
    assert port_logging.warn_once(key, "careful") is False
    assert capsys.readouterr().err == "careful\n"
    assert port_logging.AverageMeter is port_registry.AverageMeter
    assert port_logging.Throughput is port_registry.Throughput
    with pytest.raises(AttributeError):
        port_logging.Nope  # noqa: B018


def test_report_cli_renders_jsonl_and_names_unported(tmp_path, capsys):
    recs = _script(port_registry, lambda x: torch.tensor(x))
    path = tmp_path / "run.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert port_report.main([str(path)]) == 0
    assert "step-metrics summary" in capsys.readouterr().out
    # timeline renders a device trace (a GEMM and an NCCL kernel on two
    # streams of one card), fleet the run dir holding both files
    trace = tmp_path / "dev.trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x64_NNT",
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 40.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum",
         "pid": 0, "tid": 8, "ts": 20.0, "dur": 40.0,
         "args": {"device": 0}}]}))
    assert port_report.main(["timeline", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "(1 devices, 1 steps)" in out and "GPU:0" in out
    assert "exposed 0.020 ms (fraction 0.500)" in out
    assert port_report.main(["fleet", str(tmp_path)]) == 0
    assert "fleet view  (1 hosts" in capsys.readouterr().out
    # control renders a CONTROL.json (1 and an error line on a bad path)
    from apex_tpu_torch.control import (build_doc, default_policies,
                                        write_doc)
    ctl_path = write_doc(build_doc(
        enabled=True, windows=2, max_actions=3,
        policies=[p.row() for p in default_policies()], decisions=[],
        status="completed"), directory=str(tmp_path))
    assert port_report.main(["control", ctl_path]) == 0
    assert "control ledger  status=completed" in capsys.readouterr().out
    assert port_report.main(["control", str(tmp_path / "x")]) == 1
    assert "error" in capsys.readouterr().out


def test_demo_on_the_cpu_overflows_once(tmp_path):
    """The CLI demo: the port's transformer under O5 + FusedAdam with a
    dynamic scale, one forced-inf step."""
    s = port_report.run_demo(str(tmp_path / "demo.jsonl"), steps=4,
                             overflow_at=2, layers=1, batch=2, seq=8,
                             d_model=32, device="cpu")
    assert s["steps"] == 4 and s["overflow_events"] == 1
    assert s["loss_scale"] == 2.0 ** 15
    assert s["loader_wait_ms"]["count"] == 4
    assert jax_registry.records_violations(
        port_report.load_records(str(tmp_path / "demo.jsonl"))) == []
    assert np.isfinite(s["step_time_ms"]["mean"])
