"""The port's profiling shim (``apex_tpu_torch.pyprof``) against the JAX
package's.

``parse.events_from_chrome`` of both packages on the same raw Chrome
event list give the same events, exactly: a list without categories
parses to the JAX shape itself, and a Kineto list (host ``cpu_op`` /
``user_annotation`` spans, device ``kernel`` / ``gpu_memcpy`` /
``gpu_user_annotation`` ones, metadata, a torn record) to the JAX events
plus each record's ``cat``.  Self times, the op table and its rendering
equal the JAX ones on those events.  ``prof``'s ceilings keep the JAX
``cpu`` row and override grammar and gain an ``h100`` row; its
calibration equals the JAX one on the same artifact.  ``annotate`` forms
the JAX names and opens them through the spans' range helper
(``telemetry.trace.profiler_range``), ``trace`` writes a ``torch.profiler`` Chrome trace that
``parse.load`` reads back with the step ranges in it, and ``server``
raises ``NotImplementedError``.
"""
import copy
import os

import pytest
import torch

from apex_tpu.pyprof import parse as jax_parse
from apex_tpu.pyprof import prof as jax_prof

from apex_tpu_torch import pyprof
from apex_tpu_torch.pyprof import parse as port_parse
from apex_tpu_torch.pyprof import prof as port_prof
from apex_tpu_torch.telemetry import trace as port_trace


def _raw(kineto: bool):
    """A raw traceEvents list: metadata, host spans nesting, a device
    lane, a torn record (no ``dur``) and an instant."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 118,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 118, "tid": 118,
         "args": {"name": "MainThread"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python3"}},
        {"ph": "X", "name": "train.step", "pid": 118, "tid": 118,
         "ts": 100.0, "dur": 500.0, "args": {"External id": 7}},
        {"ph": "X", "name": "aten::mm", "pid": 118, "tid": 118,
         "ts": 110.0, "dur": 80.0, "args": {}},
        {"ph": "X", "name": "aten::mm", "pid": 118, "tid": 118,
         "ts": 200.0, "dur": 60.0, "args": {}},
        {"ph": "X", "name": "cudaLaunchKernel", "pid": 118, "tid": 118,
         "ts": 210.0, "dur": 9.0, "args": {}},
        {"ph": "X", "name": "train.step", "pid": 0, "tid": 7,
         "ts": 300.0, "dur": 250.0, "args": {"External id": 7}},
        {"ph": "X", "name": "nvjet_tst_128x64_NNT", "pid": 0, "tid": 7,
         "ts": 300.0, "dur": 120.0, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "name": "Memcpy DtoD (Device -> Device)", "pid": 0,
         "tid": 7, "ts": 450.0, "dur": 100.0, "args": {"device": 0}},
        {"ph": "X", "name": "torn", "pid": 0, "tid": 7, "ts": 600.0},
        {"ph": "i", "name": "mark", "pid": 118, "tid": 118, "ts": 5.0},
    ]
    if kineto:
        cats = ["user_annotation", "cpu_op", "cpu_op", "cuda_runtime",
                "gpu_user_annotation", "kernel", "gpu_memcpy", "kernel"]
        for e, c in zip([e for e in ev if e["ph"] == "X"], cats):
            e["cat"] = c
    return ev


@pytest.mark.parametrize("kineto", [False, True])
def test_events_from_chrome_equal_jax(kineto):
    raw = _raw(kineto)
    port = port_parse.events_from_chrome(copy.deepcopy(raw))
    jax = jax_parse.events_from_chrome(copy.deepcopy(raw))
    assert port.dropped_events == jax.dropped_events == 1
    assert [{k: v for k, v in e.items() if k != "cat"} for e in port] == \
        list(jax)
    cats = [e.get("cat") for e in port]
    if kineto:
        assert cats == [r.get("cat") for r in raw
                        if r["ph"] == "X" and "dur" in r]
    else:
        assert cats == [None] * len(port)


@pytest.mark.parametrize("kineto", [False, True])
def test_op_table_and_format_equal_jax(kineto):
    port = port_parse.events_from_chrome(_raw(kineto))
    jax = jax_parse.events_from_chrome(_raw(kineto))
    pt, jt = port_parse.op_table(port), jax_parse.op_table(jax)
    assert pt == jt
    assert port_parse.format_table(pt, top=3) == \
        jax_parse.format_table(jt, top=3)
    by = {r["name"]: r for r in pt}
    # the host step range's self time is its 500 us less its two mm
    # children and the launch nested in the second
    assert by["train.step"]["count"] == 2
    assert by["aten::mm"]["self_us"] == 80.0 + 60.0 - 9.0


def test_python_frames_are_left_out_by_category():
    raw = _raw(True) + [{"ph": "X", "cat": "python_function",
                         "name": "train.py(12): step", "pid": 118,
                         "tid": 118, "ts": 100.0, "dur": 3.0, "args": {}}]
    names = {r["name"] for r in port_parse.op_table(
        port_parse.events_from_chrome(raw))}
    assert "train.py(12): step" not in names
    names = {r["name"] for r in port_parse.op_table(
        port_parse.events_from_chrome(raw), include_python=True)}
    assert "train.py(12): step" in names


def test_ceilings_keep_the_jax_cpu_row_and_grammar(monkeypatch):
    monkeypatch.delenv(port_prof.ENV_CEILINGS, raising=False)
    monkeypatch.delenv(jax_prof.ENV_CEILINGS, raising=False)
    assert port_prof.ENV_CEILINGS == jax_prof.ENV_CEILINGS
    assert port_prof.CEILING_KEYS == jax_prof.CEILING_KEYS
    assert port_prof.HW_CEILINGS["cpu"] == jax_prof.HW_CEILINGS["cpu"]
    assert port_prof.HW_CEILINGS["gpu"] == jax_prof.HW_CEILINGS["gpu"]
    assert port_prof.resolve_ceilings("cpu") == \
        jax_prof.resolve_ceilings("cpu")
    h100 = port_prof.HW_CEILINGS["h100"]
    assert h100["peak_flops"] == 989e12 and h100["peak_bw"] == 3.35e12
    assert h100["hbm_bytes"] == 80e9 and h100["ici_bw"] == 450e9
    assert set(h100) <= set(port_prof.CEILING_KEYS)
    monkeypatch.setenv(port_prof.ENV_CEILINGS, "h100,peak_bw=3e12")
    row = port_prof.resolve_ceilings("cpu")
    assert row["peak_flops"] == 989e12 and row["peak_bw"] == 3e12
    monkeypatch.setenv(port_prof.ENV_CEILINGS, "peak_flop=1")
    with pytest.raises(ValueError, match="unknown ceiling"):
        port_prof.resolve_ceilings("cpu")
    monkeypatch.setenv(port_prof.ENV_CEILINGS, "v9")
    with pytest.raises(ValueError, match="unknown ceilings row"):
        port_prof.resolve_ceilings("cpu")
    assert port_prof.platform_of("cpu") == "cpu"


def test_calibration_equals_jax():
    art = {"detail": {"plan": {"leg": "plan", "calibration_scale": 1.7,
                               "family_calibration": {"dp": 1.5, "tp": 2.1,
                                                      "sp": 1.9}}}}
    for row in ("cpu", "gpu"):
        base = port_prof.HW_CEILINGS[row]
        assert port_prof.calibrate_ceilings(base, art) == \
            jax_prof.calibrate_ceilings(base, art)
    with pytest.raises(ValueError):
        port_prof.calibrate_ceilings(port_prof.HW_CEILINGS["cpu"], {})


def test_annotate_names_and_trace_round_trip(tmp_path):
    names = []
    orig = port_trace.profiler_range

    def spy(name):
        names.append(name)
        return orig(name)
    port_trace.profiler_range = spy
    try:
        with pyprof.annotate("fwd", layer=3, kind="attn"):
            pass

        @pyprof.annotate_function
        def step():
            return torch.ones(4) * 2

        @pyprof.annotate_function(name="named")
        def other():
            return None
        step()
        other()
    finally:
        port_trace.profiler_range = orig
    assert names == ["fwd|layer=3,kind=attn", "step", "named"]

    with pyprof.trace(str(tmp_path)):
        for _ in range(2):
            with pyprof.annotate("train.step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and pyprof._state.trace_paths[-1].endswith(
        files[0])
    events = port_parse.load(str(tmp_path))
    steps = [e for e in events if e["name"] == "train.step"]
    assert len(steps) == 2 and all(e["cat"] == "user_annotation"
                                   for e in steps)
    with pytest.raises(RuntimeError, match="no pyprof trace"):
        pyprof.stop_trace()


def test_init_banner_and_server(capsys):
    pyprof.init()
    assert pyprof.is_initialized()
    assert "torch.profiler" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="dynolog"):
        pyprof.server()
