"""One run of one cell: find its files by name, check the card, set up
the program, measure the window, judge the outputs and print the result.

Everything that belongs to one configuration, cell or metric lives in a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``perfbench/configs/<config>.json`` (its ``driver`` names
``perfbench/drivers/<driver>.py``), ``perfbench/workloads/<cell>.json`` and
``perfbench/metrics/<metric>.py``."""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "apex_tpu")


class CellError(Exception):
    """A run that must end without a result."""


def load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entry, configuration, workload, driver and metric readers,
    found by name under ``root``."""

    def __init__(self, root: Path, name: str):
        bench = _json(root / "BENCHMARK.json")
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[0]
        base = root / "perfbench"
        self.config = _json(base / "configs" / f"{self.entry['config']}.json")
        self.workload = _json(base / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.workload[key] != self.entry[key]:
                raise CellError(f"workloads/{name}.json has {key} "
                                f"{self.workload[key]!r}, BENCHMARK.json "
                                f"{self.entry[key]!r}")
        self.driver = load_module(
            base / "drivers" / f"{self.config['driver']}.py",
            f"perfbench_driver_{self.config['driver']}")
        self.metrics = {}
        for section in ("end_to_end", "per_layer"):
            self.metrics[section] = [
                m for m in bench[section]
                if "workloads" not in m or name in m["workloads"]]
        self.readers = {
            m["name"]: load_module(base / "metrics" / f"{m['name']}.py",
                                   "perfbench_metric_"
                                   + m["name"].replace(".", "_")).read
            for ms in self.metrics.values() for m in ms}


def read_metrics(cell: Cell, section: str, rec: dict) -> Dict[str, dict]:
    """Every metric of ``section`` that this cell reports and its reader
    finds something for."""
    out = {}
    for m in cell.metrics[section]:
        v = cell.readers[m["name"]](rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> dict:
    """One run; returns the result line's object.  Raises ``CellError``
    where no result may be printed.  ``device``: None takes the card after
    checking that the cell's cards are there; the tests pass the CPU."""
    import torch
    from perfbench.lib import trace as tracing
    cell = Cell(root, name)
    chips = cell.entry["chips"]
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            raise CellError(f"cell {name} needs {chips} CUDA card(s); "
                            f"this machine has {n}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    log(f"cell {name}: {kind} ({card_line() if on_card else 'no card'}); "
        f"built-in routes, no tuning profile; seed {seed}, {seconds} s, "
        f"trace {int(trace)}")
    torch.backends.cudnn.benchmark = bool(
        cell.workload.get("cudnn_benchmark", False))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    prog = cell.driver.Run(cell.config, cell.workload, seed, device)
    setup_s = time.perf_counter() - t_start
    rec = {"setup_s": setup_s, "items_per_step": prog.items_per_step,
           "item_unit": prog.item_unit, "flops_per_step": prog.flops_per_step,
           "kernel_shapes": prog.kernel_shapes}
    attempted, raised = 0, None
    try:
        if trace:
            rec["trace"] = tracing.traced_window(
                prog.step, seconds, cell.workload["trace_max_steps"])
            attempted = rec["trace"]["steps"] + 1
        else:
            sync()
            t0 = time.perf_counter()
            while True:
                prog.step()
                attempted += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            rec["window_s"] = time.perf_counter() - t0
            rec["steps"] = attempted
            log(f"window: {attempted} steps in {rec['window_s']:.4f} s")
    except (RuntimeError, ValueError) as e:   # a step that raised
        raised = e
        attempted += 1
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec["peak_bytes"] = peak
    done = prog.finish()
    failed = done["failed"] + (raised is not None)
    for note in done["notes"]:
        log(note)
    if raised is not None:
        log(f"a step raised: {raised!r}")
    gc.collect()
    checks = prog.compare() if raised is None else []
    correct = raised is None and failed == 0 and bool(checks) \
        and all(c["ok"] for c in checks)

    section = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(cell, section, rec)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": chips,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
