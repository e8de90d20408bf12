"""The port's live-memory and OOM half of ``telemetry.memory`` against the
JAX package's.

``dump_oom`` over the injected fault (``synthetic_oom``), over torch's
CUDA out-of-memory message with a ``memory_snapshot()``-shaped segment
list, and over the JAX package's allocator report, each with a flight
ring, a registry's monitor history and a registered attribution, writes
a ``flight-oom-*.json`` that the JAX ``oom_violations`` accepts.
``is_oom_error`` knows ``torch.cuda.OutOfMemoryError`` and the
out-of-memory texts; ``parse_allocator_report`` reads torch's requested
size and the snapshot's live blocks, and the JAX package's stanzas as the
JAX parser does.  Without CUDA the monitor finds no allocator, stops
probing and leaves the registry's records alone.  The CLI renders a dump.
"""
import json

import pytest

import torch

from apex_tpu.telemetry import memory as jax_memory

from apex_tpu_torch.telemetry import memory as port_memory
from apex_tpu_torch.telemetry import registry as port_registry
from apex_tpu_torch.telemetry import trace as port_trace

TORCH_OOM = (
    "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
    "capacity of 79.11 GiB of which 61.50 GiB is free. Of the allocated "
    "memory 16.00 GiB is allocated by PyTorch, and 2.00 MiB is reserved "
    "by PyTorch but unallocated.")

SNAPSHOT = [
    {"device": 0, "segment_type": "large", "total_size": 2 ** 31,
     "blocks": [{"size": 2 ** 30, "state": "active_allocated"},
                {"size": 2 ** 29, "state": "inactive"},
                {"size": 2 ** 28, "state": "active_allocated"}]},
    {"device": 0, "segment_type": "small", "total_size": 2 ** 21,
     "blocks": [{"size": 512, "state": "active_allocated"}]},
]


@pytest.fixture(autouse=True)
def _defaults():
    prev = port_memory.set_attribution(None)
    yield
    port_memory.set_attribution(prev)


def test_is_oom_error():
    assert port_memory.is_oom_error(port_memory.synthetic_oom(3))
    assert port_memory.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert port_memory.is_oom_error(RuntimeError(TORCH_OOM))
    assert port_memory.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not port_memory.is_oom_error(ValueError("shape mismatch"))
    assert jax_memory.is_oom_error(RuntimeError(TORCH_OOM))


def test_parse_allocator_report():
    rep = port_memory.parse_allocator_report(TORCH_OOM, SNAPSHOT)
    assert rep["requested_bytes"] == 20 * 2 ** 30
    assert [a["size_bytes"] for a in rep["allocations"]] == [
        2 ** 30, 2 ** 28, 512]
    assert port_memory.parse_allocator_report("nothing") == {
        "requested_bytes": None, "allocations": []}
    xla = str(jax_memory.synthetic_oom(4))
    assert (port_memory.parse_allocator_report(xla)
            == jax_memory.parse_allocator_report(xla))
    inj = port_memory.parse_allocator_report(
        str(port_memory.synthetic_oom(2, nbytes=3 * 2 ** 30)))
    assert inj["requested_bytes"] == 3 * 2 ** 30


@pytest.mark.parametrize("kind", ["injected", "torch", "jax_text"])
def test_dump_oom_passes_the_jax_schema(tmp_path, kind):
    err = {"injected": port_memory.synthetic_oom(7),
           "torch": torch.cuda.OutOfMemoryError(TORCH_OOM),
           "jax_text": RuntimeError(str(jax_memory.synthetic_oom(7)))}[kind]
    tr = port_trace.Tracer(enabled=True, ring=16)
    with tr.span("train.step", step=7):
        pass
    reg = port_registry.Registry(sink=port_registry.MemorySink(),
                                 rank0_only=False, memory=False)
    model = {"peak_hbm_bytes": 123, "by_class": {"params": 100,
                                                 "temps": 23}}
    assert port_memory.set_attribution(model) is None
    assert port_memory.get_attribution() is model
    path = port_memory.dump_oom(
        tr.recorder, step=7, error=err, directory=str(tmp_path),
        registry=reg, snapshot=SNAPSHOT if kind == "torch" else False)
    assert "flight-oom-" in path
    doc = json.load(open(path))
    assert jax_memory.oom_violations(doc) == []
    assert port_memory.oom_violations(doc) == []
    sec = doc["oom"]
    assert sec["bad_step"] == 7 and sec["attribution"] == model
    assert sec["error_type"] == type(err).__name__
    if kind == "torch":
        assert sec["requested_bytes"] == 20 * 2 ** 30
        assert len(sec["allocations"]) == 3
    # no recorder and no destination: nothing written
    assert port_memory.dump_oom(step=1, error=err, snapshot=False) is None
    bad = dict(doc, oom=dict(sec, bad_step="x"))
    assert port_memory.oom_violations(bad) == jax_memory.oom_violations(bad)
    assert port_memory.oom_violations({"kind": "flight_recorder"}) == \
        jax_memory.oom_violations({"kind": "flight_recorder"})


def test_monitor_without_cuda_is_a_noop(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_memory.device_memory_stats() is None
    assert port_memory.device_memory_json() == ""
    mon = port_memory.MemoryMonitor(enabled=True)
    sink = port_registry.MemorySink()
    reg = port_registry.Registry(sink=sink, rank0_only=False, memory=mon,
                                 flush_interval=1)
    with reg.step():
        pass
    assert mon.supported is False and mon.snapshot() == []
    assert not any(r.get("name", "").startswith("mem.")
                   for r in sink.records)
    monkeypatch.setenv("APEX_TPU_TELEMETRY_MEM", "0")
    assert port_memory.MemoryMonitor().enabled is False
    assert port_registry.Registry()._memory is None


def test_monitor_feeds_gauges_history_and_counter_track(monkeypatch):
    """With allocator stats (a stand-in for ``torch.cuda.memory_stats``
    here), each flush sets the mem.* gauges, grows the history the OOM
    dump embeds, and samples the tracer's device_mem counter track."""
    stats = iter([{"bytes_in_use": 10, "peak_bytes_in_use": 20,
                   "bytes_limit": 100},
                  {"bytes_in_use": 15, "peak_bytes_in_use": 30,
                   "bytes_limit": 100}])
    monkeypatch.setattr(port_memory, "device_memory_stats",
                        lambda device=None: next(stats))
    tr = port_trace.Tracer(enabled=True)
    prev = port_trace.set_tracer(tr)
    try:
        mon = port_memory.MemoryMonitor(enabled=True)
        sink = port_registry.MemorySink()
        reg = port_registry.Registry(sink=sink, rank0_only=False,
                                     memory=mon, flush_interval=1,
                                     goodput=False, exporter=False)
        for _ in range(2):
            with reg.step():
                pass
    finally:
        port_trace.set_tracer(prev)
    peaks = [r["value"] for r in sink.records
             if r.get("name") == "mem.peak_bytes_in_use"]
    assert peaks == [20.0, 30.0]
    assert [h["bytes_in_use"] for h in mon.snapshot()] == [10.0, 15.0]
    counters = [e for e in tr.export()["traceEvents"] if e["ph"] == "C"]
    assert [c["args"]["peak_bytes_in_use"] for c in counters] == [20.0, 30.0]


def test_mem_cli_renders_a_dump(tmp_path, capsys):
    path = port_memory.dump_oom(step=2, error=port_memory.synthetic_oom(2),
                                directory=str(tmp_path), snapshot=False)
    assert port_memory.cli([path]) == 0
    assert "OOM post-mortem" in capsys.readouterr().out
    other = tmp_path / "x.json"
    other.write_text("{}")
    assert port_memory.cli([str(other)]) == 1
