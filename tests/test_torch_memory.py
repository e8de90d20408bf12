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

The static half: ``classify_arg`` bins every keypath as the JAX one does;
``memory_table`` over a 2-layer, 64-wide O5 BERT step on the CPU puts
exactly the state's bytes in the params, optimizer and batch classes
(the bf16 model; the fp32 flat master, moments and scalers; the token
tensors), its classes partition the sweep's peak, and ``memory_model`` of
the port's table is the JAX ``memory_model`` of the same table; a
hand-made call pins the sweep's def / death semantics; the registered
model rides into the OOM dump the JAX schema accepts.
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


# ---------------------------------------------------------------------------
# the static half: the liveness sweep over one recorded call
# ---------------------------------------------------------------------------

KEY_PATHS = ["state['model_params']['w']", r"state[\'opt\'][\'m\']",
             "state.master_params['fc']", "state.scalers[0].loss_scale",
             "tokens", "x", "y", "mystery_arg", "state.m", "state.v",
             "amp_state.opt_state.master", "amp_state.opt_state.count",
             "amp_state.model_params['layers']['wqkv']",
             "batch['targets']", "model_params['m']", "m_tokens",
             "vectors", "boost", "images", "state.exp_avg['w']"]


def test_classify_arg_equals_jax():
    assert port_memory.MEM_CLASSES == jax_memory.MEM_CLASSES
    for path in KEY_PATHS:
        assert port_memory.classify_arg(path) == \
            jax_memory.classify_arg(path), path


def _storage_bytes(tree):
    from apex_tpu_torch.telemetry.attrib import keyed_tensors
    seen = {}
    for _, t in keyed_tensors(tree, "x"):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def test_memory_table_classes_are_the_states_bytes():
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import TransformerConfig, transformer_init
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import train_step
    cfg = TransformerConfig(vocab_size=128, max_len=32, num_layers=2,
                            d_model=64, num_heads=4, d_ff=256,
                            dtype=torch.bfloat16, attn_impl="fast",
                            remat=True)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    st = amp.initialize(params, FusedLAMB(impl="fused"), opt_level="O5",
                        verbosity=0)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, 128, (2, 32), generator=gen)
             for k in ("tokens", "targets")}
    table = port_memory.memory_table(train_step, st, batch, cfg)
    by = table["by_class"]
    assert by["params"] == _storage_bytes(st.model_params)
    assert by["optimizer"] == _storage_bytes((st.opt_state, st.scalers))
    assert by["optimizer"] >= 3 * 4 * st.opt_state.master.numel()
    assert by["batch"] == _storage_bytes(batch)
    assert sum(by.values()) == table["peak_bytes"]
    assert by["activations"] > 0 and table["stats"] is None
    assert table["platform"] == "cpu"
    assert table["peak_op"] == f"{table['peak_op'].rsplit('.', 1)[0]}." \
        f"{table['peak_index']}"
    model = port_memory.memory_model(table=table, register=False)
    assert model == jax_memory.memory_model(table=dict(table),
                                            register=False)
    assert model["params_bytes"] == by["params"]
    assert sum(v for k, v in model.items() if k.endswith("_bytes") and k
               not in ("peak_hbm_bytes", "optimizer_bytes_per_replica")) \
        == model["peak_hbm_bytes"]
    text = port_memory.format_memory_table(table, top=4)
    assert "per-class residency at peak" in text and "optimizer" in text


def test_liveness_sweep_semantics():
    """Defs at the producing op, deaths at the first op after the storage
    is gone; the caller's arguments live throughout; at the peak, a
    storage that dies there is ``temps``, one held across it
    ``activations``, one the result holds ``output``."""
    def fn(x):                     # x: 1024 fp32, 4 KB
        a = x * 2.0                # 0: a, 4 KB, returned
        b = torch.cat([a, a])      # 1: b, 8 KB, read by op 2 only
        c = b.sum()                # 2: c, 4 B -- the peak
        del b
        d = a * c                  # 3: d, 4 KB (b found dead here)
        return d.sum(), a          # 4: the sum, 4 B

    x = torch.ones(1024)
    table = port_memory.memory_table(fn, x)
    kb = 4096
    assert table["n_instructions"] == 5
    assert table["peak_index"] == 2 and table["peak_op"] == "sum.2"
    assert table["peak_bytes"] == 4 * kb + 4      # x, a, b, c
    rows = {r["op"]: r for r in table["live_at_peak"]}
    assert rows["x"]["class"] == "batch" and rows["x"]["def_index"] == 0
    assert rows["mul.0"]["class"] == "output"
    assert rows["cat.1"]["class"] == "temps"
    assert (rows["cat.1"]["def_index"], rows["cat.1"]["last_use"]) == (1, 2)
    assert rows["sum.2"]["class"] == "activations"
    assert table["by_class"] == {"batch": kb, "output": kb,
                                 "temps": 2 * kb, "activations": 4}
    assert [p["bytes"] for p in table["timeline"]] == \
        [2 * kb, 4 * kb, 4 * kb + 4, 3 * kb + 4, 3 * kb + 8]


def test_registered_model_rides_into_the_oom_dump(tmp_path):
    table = port_memory.memory_table(lambda x: (x * 2).sum(),
                                     torch.ones(256))
    model = port_memory.memory_model(table=table)
    assert port_memory.get_attribution() is model
    path = port_memory.dump_oom(step=3, error=port_memory.synthetic_oom(3),
                                directory=str(tmp_path), snapshot=False)
    doc = json.load(open(path))
    assert jax_memory.oom_violations(doc) == []
    assert doc["oom"]["attribution"]["peak_hbm_bytes"] == \
        model["peak_hbm_bytes"]


def test_mem_cli_renders_the_demo_step(capsys):
    assert port_memory.cli(["--device", "cpu", "--layers", "1", "--batch",
                            "2", "--seq", "8"]) == 0
    out = capsys.readouterr().out
    assert "peak-memory attribution (cpu;" in out
    assert "memory_model: peak" in out
