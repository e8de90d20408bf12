"""The port's device timeline (``apex_tpu_torch.telemetry.timeline``)
against the JAX package's.

On the same synthetic event lists (the JAX tests' ``dev`` / ``host``
shapes: HLO-named device lanes, host ``train.step`` spans) the port's
``decompose``, ``straggler_rows``, ``merge_host_device``,
``format_decomposition`` and the interval core (``_merge`` /
``_subtract`` / ``_clip`` / ``_total_us``) give exactly the JAX results:
the same arithmetic on the same floats, compared with ``==`` (the merged
document's ``alignment`` aside, port-only).  A Kineto
trace of one full-width O5 BERT-large step, captured on the card by
``chip_smoke.py`` phase 25 and trimmed to that step's device work and
step ranges (``torch_fixtures/o5_step_trace.json.gz``), decomposes into
the split the test computes by hand from the kernels' intervals (to
1e-6 ms, the decomposition's rounding), and its hand-kernel launches,
found by their CUDA function names, are phase 7's a step.  The goodput
ledger's exposed-comm carve, fed a decomposition, partitions the wall
exactly as the JAX ledger does.  The guard's ``train.step`` span, mirrored
into a CPU capture, gives one step window a step, and aligns the
tracer's spans onto the capture.
"""
import gzip
import json
import os

import numpy as np
import pytest

from apex_tpu.telemetry import goodput as jax_goodput
from apex_tpu.telemetry import registry as jax_registry
from apex_tpu.telemetry import timeline as jax_tl

from apex_tpu_torch.pyprof import parse as port_parse
from apex_tpu_torch.telemetry import goodput as port_goodput
from apex_tpu_torch.telemetry import registry as port_registry
from apex_tpu_torch.telemetry import timeline as port_tl

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "o5_step_trace.json.gz")
#: phase 7's hand-kernel launches a step (chip_smoke.py
#: TRAIN_LAUNCHES_PER_STEP["o5_lamb"], the kernels it launches)
O5_LAUNCHES = {"flash_fwd": 48, "ln_fwd": 98, "ln_bwd": 50, "xent_fwd": 1,
               "flash_bwd": 24, "l2norm": 1}


def dev(name, ts, dur, device=0, args=None):
    """One parsed device event (the pyprof.parse shape, no category)."""
    return {"name": name, "ts": float(ts), "dur": float(dur),
            "pid": device + 10, "tid": 1,
            "process": f"/device:TPU:{device}", "thread": "XLA Op",
            "args": args or {}}


def host(name, ts, dur, step=None):
    args = {} if step is None else {"step": step}
    return {"name": name, "ts": float(ts), "dur": float(dur),
            "pid": 1, "tid": 1, "process": "apex_tpu",
            "thread": "MainThread", "args": args}


def _oracle():
    return [dev("fusion.1", 0, 100, device=0),
            dev("all-reduce.2", 50, 100, device=0),
            dev("fusion.1", 0, 100, device=1),
            dev("all-reduce.2", 20, 40, device=1),
            dev("all-reduce-start.9", 200, 60, device=2)]


def _split():
    return [dev("fusion.1", 0, 80), dev("all-reduce.1", 40, 30),
            dev("all-reduce.2", 70, 30)]


def _stepped_mesh():
    """Four devices, three host-windowed steps, device 3 slow in step 1,
    collectives partly hidden."""
    evs = []
    for s in range(3):
        t0 = 1000.0 * s
        evs.append(host("train.step", t0, 900, step=s))
        for d in range(4):
            busy = 600 if (s == 1 and d == 3) else 300
            evs.append(dev("fusion.3", t0 + 10, busy, device=d))
            evs.append(dev("all-gather.4", t0 + 250, 120, device=d))
            evs.append(dev("copy.5", t0 + 700, 13.5, device=d))
    return evs


def _hlo_lane():
    """No device-named process: an HLO-shaped lane on a CPU capture,
    runtime noise beside it."""
    def ev(name, ts, dur, thread="tf_XLA"):
        return {"name": name, "ts": float(ts), "dur": float(dur), "pid": 3,
                "tid": 7, "process": "/host:CPU", "thread": thread,
                "args": {}}
    return [ev("fusion.2", 0, 40), ev("dot.1", 40, 20),
            ev("ThunkExecutor::Execute", 0, 100),
            ev("all-reduce.3", 50, 30), ev("python frame", 0, 5, "py")]


SCENARIOS = {"oracle": _oracle, "split": _split, "mesh": _stepped_mesh,
             "hlo_lane": _hlo_lane, "empty": lambda: []}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decompose_equals_jax(scenario):
    evs = SCENARIOS[scenario]()
    assert port_tl.decompose(evs) == jax_tl.decompose(evs)
    assert port_tl.step_windows(evs) == jax_tl.step_windows(evs)
    assert port_tl.device_lanes(evs) == jax_tl.device_lanes(evs)


@pytest.mark.parametrize("scenario", ["oracle", "mesh"])
def test_format_and_straggler_flags_equal_jax(scenario):
    evs = SCENARIOS[scenario]()
    d = port_tl.decompose(evs, z_threshold=1.5)
    assert d == jax_tl.decompose(evs, z_threshold=1.5)
    assert port_tl.format_decomposition(d) == \
        jax_tl.format_decomposition(d)
    if scenario == "mesh":
        assert [(r["step"], r["device"]) for r in d["stragglers"]] == \
            [(1, "/device:TPU:3")]


@pytest.mark.parametrize("seed", range(6))
def test_straggler_rows_equal_jax(seed):
    rng = np.random.default_rng(seed)
    steps = []
    for s in range(5):
        busy = rng.uniform(10, 12, size=int(rng.integers(1, 6)))
        if seed % 2 and s == 2:
            busy[0] *= 3.0
        steps.append({"step": s, "devices": {
            f"d{i}": {"busy_ms": float(b)} for i, b in enumerate(busy)}})
    for kw in ({}, {"z_threshold": 1.0, "min_slowdown": 1.01}):
        assert port_tl.straggler_rows(steps, **kw) == \
            jax_tl.straggler_rows(steps, **kw)


@pytest.mark.parametrize("seed", range(8))
def test_interval_core_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)

    def ivals(n):
        s = rng.uniform(0, 1000, n)
        return [(float(a), float(a + w)) for a, w in
                zip(s, rng.uniform(-5, 80, n))]
    a, b = ivals(int(rng.integers(0, 40))), ivals(int(rng.integers(0, 40)))
    ma, mb = port_tl._merge(a), port_tl._merge(b)
    assert ma == jax_tl._merge(a) and mb == jax_tl._merge(b)
    sub = port_tl._subtract(ma, mb)
    assert sub == jax_tl._subtract(ma, mb)
    assert port_tl._clip(ma, 200.0, 700.0) == jax_tl._clip(ma, 200.0, 700.0)
    assert port_tl._total_us(sub) == jax_tl._total_us(sub)
    # the goodput ledger partitions with the same core
    assert port_goodput._subtract is port_tl._subtract
    assert port_goodput._merge is port_tl._merge


def test_event_op_class_on_hlo_names_equals_jax():
    for name in ("all-reduce.7", "all-reduce-start.7", "reduce-scatter-done.2",
                 "dot.3", "fusion.12", "copy.1", "convolution.4", "reduce.9",
                 "custom-call.1", "$main.py:12 train", "Thread 7", "tanh"):
        assert port_tl.event_op_class(name) == jax_tl.event_op_class(name)
        assert port_tl.is_collective_event(name) == \
            jax_tl.is_collective_event(name)


def test_merge_host_device_equals_jax():
    devs = _stepped_mesh()
    hosts = [host("train.step", 5.0 + 1000 * s, 800, step=s)
             for s in range(3)]
    # no mirrored span in these lists: the port guesses as the JAX module
    # does, and says so
    for off, method in ((None, "first_event_guess"), (17.25, "given")):
        doc = port_tl.merge_host_device(hosts, devs, host_offset_us=off)
        assert doc.pop("alignment")["method"] == method
        assert doc == jax_tl.merge_host_device(hosts, devs,
                                               host_offset_us=off)


def test_kernel_names_bin_into_classes():
    """Kineto device events bin by their CUDA kernel names."""
    k = "kernel"
    assert port_tl.event_op_class("ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                                  k) == "collective"
    assert port_tl.event_op_class("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT",
                                  k) == "blas"
    assert port_tl.event_op_class(
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", k) \
        == "blas"
    assert port_tl.event_op_class(
        "sm80_xmma_fprop_implicit_gemm_indexed_tf32f32", k) == "conv"
    assert port_tl.event_op_class(
        "void (anonymous namespace)::flash_fwd_sm90_kernel<__nv_bfloat16, "
        "64, 2>(CUtensorMap_st)", k) == "other"
    assert port_tl.event_op_class("Memcpy DtoD (Device -> Device)",
                                  "gpu_memcpy") == "memory"
    assert port_tl.event_op_class(
        "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>"
        "(at::native::ReduceOp<float>)", k) == "reduction"
    assert port_tl.event_op_class(
        "void at::native::vectorized_elementwise_kernel<8, "
        "at::native::GeluCUDAKernelImpl>(int)", k) == "pointwise"
    # a host span of a Kineto trace is no device op
    assert port_tl.event_op_class("aten::mm", "cpu_op") is None


def _fixture_events():
    with gzip.open(FIXTURE, "rt") as f:
        raw = json.load(f)["traceEvents"]
    return raw, port_parse.events_from_chrome(raw)


def test_kineto_step_decomposes_as_computed_by_hand():
    raw, events = _fixture_events()
    d = port_tl.decompose(events)
    assert d["devices"] == ["GPU:0"] and d["n_steps"] == 1
    # the device window: the step range's mirror on the stream, not the
    # host range (which opens earlier, when the host starts enqueueing)
    mirror = [e for e in raw if e["cat"] == "gpu_user_annotation"]
    hostr = [e for e in raw if e["cat"] == "user_annotation"]
    assert len(mirror) == 1 and len(hostr) == 1
    t0, t1 = mirror[0]["ts"], mirror[0]["ts"] + mirror[0]["dur"]
    assert hostr[0]["ts"] < t0
    assert port_tl.step_windows(events) == [(0, t0, t1)]
    # by hand: the union of the kernels', copies' and fills' intervals
    work = sorted((e["ts"], e["ts"] + e["dur"]) for e in raw
                  if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset"))
    union, cur = 0.0, None
    for s, e in work:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            union += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    union += cur[1] - cur[0]
    row = d["steps"][0]["devices"]["GPU:0"]
    assert row["comm_ms"] == 0.0 and row["exposed_comm_ms"] == 0.0
    assert row["compute_ms"] == pytest.approx(union / 1e3, abs=1e-6)
    assert row["busy_ms"] == row["compute_ms"]
    assert row["idle_ms"] == pytest.approx((t1 - t0 - union) / 1e3,
                                           abs=1e-6)
    assert d["steps"][0]["dur_ms"] == pytest.approx((t1 - t0) / 1e3,
                                                    abs=1e-6)
    # one stream: compute is the plain sum of the work's durations
    assert len({(e["pid"], e["tid"]) for e in raw
                if e["cat"] == "kernel"}) == 1
    assert row["compute_ms"] == pytest.approx(
        sum(e - s for s, e in work) / 1e3, abs=1e-3)
    assert port_tl.port_launches(events) == {0: O5_LAUNCHES}


def test_observe_exports_gauges_through_the_port_registry():
    d = port_tl.decompose(_stepped_mesh())
    sink = port_registry.MemorySink()
    reg = port_registry.Registry(sink=sink, flush_interval=0,
                                 rank0_only=False, memory=False,
                                 goodput=False, exporter=False)
    port_tl.observe(d, reg)
    reg.flush()
    recs = sink.records
    assert not jax_registry.records_violations(recs)
    got = {r["name"]: r["value"] for r in recs if r.get("kind") == "metric"}
    n = 4 * 3
    assert got["step.device_compute_ms"] == d["totals"]["compute_ms"] / n
    assert got["step.exposed_comm_ms"] == d["totals"]["exposed_comm_ms"] / n
    assert got["step.device_idle_ms"] == d["totals"]["idle_ms"] / n
    assert got["step.exposed_comm_fraction"] == \
        d["totals"]["exposed_comm_fraction"]


def test_goodput_carve_from_a_decomposition_equals_jax():
    """The same step spans and the same decomposition: the port's ledger
    carves the measured exposed-comm share exactly as the JAX one."""
    decomp = port_tl.decompose(_stepped_mesh())
    docs = []
    for mod in (port_goodput, jax_goodput):
        led = mod.GoodputLedger()
        led.t0_us = 0.0
        for s in range(3):
            led.note_span("train.step", 1000.0 * s, 900.0, step=s)
        led.note_span("data.fetch", 2900.0, 50.0)
        led.set_decomposition(decomp)
        doc = led.snapshot(now_us=3000.0, status="completed")
        doc.pop("ts", None)
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["classes"]["exposed_comm"]["ms"] > 0.0
    assert not port_goodput.goodput_violations(dict(docs[0], ts="x"))


def test_timeline_cli_renders_the_card_trace(capsys):
    assert port_tl.cli([FIXTURE]) == 0
    out = capsys.readouterr().out
    assert "(1 devices, 1 steps)" in out and "GPU:0" in out
    assert port_tl.cli([FIXTURE, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["kind"] == "device_timeline" and doc["n_steps"] == 1


def test_guard_train_step_is_mirrored_into_a_cpu_capture(tmp_path):
    """The guard's ``train.step`` span, with a tracer installed, lands in
    a ``torch.profiler`` capture on the CPU as a range of its own: one
    step window per step, and the tracer's spans merged onto the
    capture by the mirrored spans, each on its own row."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.resilience import GuardConfig, TrainGuard
    from apex_tpu_torch.telemetry import trace as port_trace

    def step(w, batch):
        g = 2.0 * (w - batch)
        return w - 0.1 * g, torch.sum((w - batch) ** 2)

    tr = port_trace.Tracer(enabled=True)
    prev = port_trace.set_tracer(tr)
    try:
        for _ in range(3):                 # steps before the capture
            with tr.span("train.step"):
                pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            TrainGuard(step, GuardConfig(enabled=True, check_every=2)).run(
                torch.zeros(4), lambda i: torch.full((4,), float(i)), 5)
    finally:
        port_trace.set_tracer(prev)
    path = str(tmp_path / "capture.pt.trace.json")
    prof.export_chrome_trace(path)
    events = port_tl.load_events(path)
    rows = sorted((e for e in events if e["name"] == "train.step"),
                  key=lambda e: e["ts"])
    assert len(rows) == 5 and {e["cat"] for e in rows} == {"user_annotation"}
    assert port_tl.step_windows(events) == [
        (i, e["ts"], e["ts"] + e["dur"]) for i, e in enumerate(rows)]
    merged = port_tl.merge_host_device(tr.export(), events)
    align = merged["alignment"]
    assert align["method"] == "mirrored_spans" and align["pairs"] >= 5
    host_pid = merged["traceEvents"][0]["pid"]
    host_steps = sorted(e["ts"] for e in merged["traceEvents"]
                        if e.get("pid") == host_pid
                        and e.get("name") == "train.step")[-5:]
    for h, r in zip(host_steps, rows):
        assert abs(h - r["ts"]) < 50.0     # us: the span and its row open
                                           # together
