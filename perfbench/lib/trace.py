"""The traced window: one profiler session over a run of steps, and the
reduction of its trace to what the per-layer readers take.

The session opens after set-up; its first step is run and thrown away,
because the profiler can miss a session's first kernels.  The steps that
follow run inside a ``perfbench.window`` range and end in a synchronize,
so every device operation of the window starts and ends inside it.  In
this run only, ``apex_tpu_torch.amp.amp_step`` runs inside a
``perfbench.amp_step`` range, where ``train.py`` calls it."""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
AMP_STEP = "perfbench.amp_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def traced_window(step: Callable[[], None], seconds: float,
                  max_steps: int) -> dict:
    """Run ``step`` under the profiler: one thrown-away step, then steps
    until ``seconds`` have passed or ``max_steps`` ran.  Returns the
    reduced trace (:func:`reduce_events`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from apex_tpu_torch import amp
    from apex_tpu_torch.utils import build
    plain = amp.amp_step

    def amp_step(*args, **kwargs):
        with record_function(AMP_STEP):
            return plain(*args, **kwargs)

    amp.amp_step = amp_step
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
            before = dict(build.LAUNCHES)
            steps = 0
            with record_function(WINDOW):
                t0 = time.perf_counter()
                while steps < max_steps:
                    step()
                    steps += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                torch.cuda.synchronize()
            launches = {k: n - before.get(k, 0)
                        for k, n in build.LAUNCHES.items()
                        if n - before.get(k, 0)}
    finally:
        amp.amp_step = plain
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_events(events, steps, launches, build.launch_name,
                         build.is_port_kernel)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict], steps: int, launches: Dict[str, int],
                  launch_name: Callable[[str], Optional[str]],
                  is_port_kernel: Callable[[str], bool]) -> dict:
    """The window's numbers from a Chrome-format trace (times in us in the
    trace, in seconds here): ``window_s``, ``busy_s`` (the union of device
    operations), ``steps``, ``launches`` (the port's launches by name in
    the window), ``port_kernel_s`` (device seconds by launch name),
    ``other_kernel_s`` (every kernel that is not the port's),
    ``amp_step_spans_s`` (first to last device operation launched inside
    each ``amp_step`` range) and ``breakdown``.  Raises ``RuntimeError``
    where the window holds no kernel."""
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} window ranges")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])

    def inside(e):
        return w0 <= float(e["ts"]) < w1

    device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    kernels = [e for e in device if e["cat"] == "kernel"]
    if not kernels:
        raise RuntimeError("the traced window holds no kernel rows: the "
                           "profiler saw no device activity")
    spans = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                         w1)) for e in device])
    busy = sum(b - a for a, b in spans)

    port: Dict[str, float] = {}
    other = 0.0
    by_name: Dict[str, float] = {}
    for e in kernels:
        dur = float(e["dur"])
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
        name = launch_name(e["name"])
        if name is not None:
            port[name] = port.get(name, 0.0) + dur
        elif not is_port_kernel(e["name"]):
            other += dur
    for e in device:
        if e["cat"] != "kernel":
            by_name[e["cat"]] = by_name.get(e["cat"], 0.0) + float(e["dur"])

    by_corr: Dict[int, List[dict]] = {}
    for e in device:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append(e)
    launch_ev = [e for e in events if e.get("cat") in LAUNCH_CATS]
    amp_spans = []
    for a in (e for e in events if e.get("name") == AMP_STEP
              and e.get("cat") == "user_annotation" and inside(e)):
        a0, a1 = float(a["ts"]), float(a["ts"]) + float(a["dur"])
        devs = [d for r in launch_ev if a0 <= float(r["ts"]) <= a1
                for d in by_corr.get(r.get("args", {}).get("correlation"), [])]
        if devs:
            amp_spans.append(
                (max(float(d["ts"]) + float(d["dur"]) for d in devs)
                 - min(float(d["ts"]) for d in devs)) * 1e-6)

    gaps = []
    edges = [w0] + [x for s in spans for x in s] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW and "dur" in e]
    idle = []
    for length, a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        cover = [e for e in host
                 if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        what = max(cover, key=lambda e: float(e["ts"]))["name"] if cover \
            else "no host operation"
        idle.append([what, length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "steps": steps,
        "launches": launches,
        "port_kernel_s": {k: v * 1e-6 for k, v in port.items()},
        "other_kernel_s": other * 1e-6,
        "amp_step_spans_s": amp_spans,
        "breakdown": {"device_ops": [[n[:200], s * 1e-6] for n, s in ops],
                      "idle_gaps": idle},
    }
