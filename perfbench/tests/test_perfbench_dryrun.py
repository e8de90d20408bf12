"""Both drivers at a tiny size on the CPU (the port's plain versions of
its kernels): set-up, a few window steps, the comparison with the
reference; and after it no top-level ``jax`` or ``apex_tpu`` in the
process.

The ResNet-50 cell is out of ``BENCHMARK.json`` until the port's batch
norm is repaired (PERF.md, Open questions); its files stay, and this run
adds its entries to the tiny copy's ``BENCHMARK.json`` as a re-add
would."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r'''
import json, sys, time
sys.path.insert(0, ROOT)
import torch
from perfbench.lib import harness
from perfbench.tests.tiny import tiny_checkout
root = tiny_checkout(sys.argv[1])
bench = json.loads((root / "BENCHMARK.json").read_text())
bench["configs"].append({"name": "resnet50", "source": "https://arxiv.org/abs/1512.03385",
                         "file": "perfbench/configs/resnet50.json",
                         "reduced": [], "why": "ResNet-50"})
bench["workloads"].append({"name": "resnet50.o2_b256", "config": "resnet50",
                           "traffic": "o2_b256", "chips": 1, "why": "ResNet-50 under O2"})
bench["end_to_end"].append({"name": "images_per_s", "unit": "images/s",
                            "better": "higher", "bound": 0.05, "source": "host_clock",
                            "workloads": ["resnet50.o2_b256"]})
(root / "BENCHMARK.json").write_text(json.dumps(bench))
out = {}
for cell in ("bert_large.pretrain_s512", "resnet50.o2_b256"):
    r = harness.run(root, cell, 2 ** 31 + 17, 0.2, False, time.perf_counter(),
                    device=torch.device("cpu"))
    out[cell] = r
out["modules"] = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps(out))
'''


def test_both_drivers_dry_run_and_load_no_jax(tmp_path):
    code = SCRIPT.replace("ROOT", repr(str(ROOT)), 1)
    out = subprocess.run([sys.executable, "-I", "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    mods = set(res.pop("modules"))
    assert "apex_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "apex_tpu"}
    for cell, r in res.items():
        assert r["failed"] == 0 and r["attempted"] >= 1, cell
        assert r["checks"], cell
        unit = "tokens/s" if cell.startswith("bert") else "images/s"
        assert any(m["unit"] == unit for m in r["metrics"].values())
