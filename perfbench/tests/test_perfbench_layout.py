"""The harness finds a cell, a configuration, a driver and a metric by
name, from files alone, and its last line keeps the contract's schema."""
import json
import shutil
import time
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]

FAKE_DRIVER = '''
import torch


class Run:
    item_unit = "widgets"
    items_per_step = 3
    flops_per_step = 1.0
    kernel_shapes = {}

    def __init__(self, config, workload, seed, device):
        self.x = torch.zeros(config["width"], device=device)
        self.steps = 0

    def step(self):
        self.x += 1.0
        self.steps += 1

    def finish(self):
        return {"failed": 0, "notes": [f"{self.steps} steps"]}

    def compare(self):
        from perfbench.lib import compare
        return compare.judge({"drift": 0.0}, {"drift": 0.5})
'''

FAKE_METRIC = '''
def read(rec):
    if rec.get("item_unit") != "widgets" or "window_s" not in rec:
        return None
    return rec["steps"] * rec["items_per_step"] / rec["window_s"]
'''


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, to which a new configuration, cell
    and metric are added as files, with their entries in BENCHMARK.json."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    base = tmp_path / "perfbench"
    (base / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "driver": "toy_driver", "width": 4}))
    (base / "drivers" / "toy_driver.py").write_text(FAKE_DRIVER)
    (base / "workloads" / "toy.tiny.json").write_text(json.dumps(
        {"name": "toy.tiny", "config": "toy", "traffic": "tiny", "chips": 1,
         "mix": {}, "trace_max_steps": 2}))
    (base / "metrics" / "widgets_per_s.py").write_text(FAKE_METRIC)
    bench["configs"].append({"name": "toy", "source": "https://example.org",
                             "file": "perfbench/configs/toy.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy.tiny", "config": "toy",
                               "traffic": "tiny", "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "widgets_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data          # no existing file edited
    return tmp_path


def test_new_cell_config_and_metric_are_found_by_name(checkout):
    cell = harness.Cell(checkout, "toy.tiny")
    assert cell.config["driver"] == "toy_driver"
    assert [m["name"] for m in cell.metrics["end_to_end"]] == [
        "peak_mem_gib", "setup_s", "widgets_per_s"]
    assert cell.metrics["per_layer"] == []
    assert set(cell.readers) == {"peak_mem_gib", "setup_s", "widgets_per_s"}
    # the existing cells still find only their own metrics
    bert = harness.Cell(checkout, "bert_large.pretrain_s512")
    assert "widgets_per_s" not in bert.readers
    assert "flash_roofline" in bert.readers


def test_missing_cell_or_file_ends_without_result(checkout):
    with pytest.raises(harness.CellError):
        harness.Cell(checkout, "toy.absent")
    (checkout / "perfbench" / "metrics" / "widgets_per_s.py").unlink()
    with pytest.raises(harness.CellError):
        harness.Cell(checkout, "toy.tiny")


def test_last_line_schema(checkout):
    import torch
    out = harness.run(checkout, "toy.tiny", 2 ** 31 + 5, 0.05, False,
                      time.perf_counter(), device=torch.device("cpu"))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"peak_mem_gib", "setup_s",
                                   "widgets_per_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"] == {"drift": {"value": 0.0, "limit": 0.5}}
    json.loads(json.dumps(out, allow_nan=False))
