"""The comparison that decides ``correct`` is shown to fail: the control
(the reference in float8 in the program's place) and each fault planted
underneath the timed path read not correct against each cell's limits,
where the program reads correct.

The ``cuda`` cases run the cell at its own size on the card, one seed
each (the readings the limits come from are ``calibrate.py``'s).  The
CPU cases run it cut to a tiny size (``tiny.py``), where the program
still keeps inside the cell's limits."""
import time

import pytest
import torch

from perfbench.lib import compare, faults, harness
from perfbench.tests.tiny import ROOT, tiny_checkout

CELLS = ("bert_large.pretrain_s512",)
SEED = 2 ** 31 + 29


def _root(tmp_path, size):
    return tiny_checkout(tmp_path) if size == "tiny" else ROOT


def _device(size):
    if size == "tiny":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _run(root, cell, device):
    return harness.run(root, cell, SEED, 0.5, False, time.perf_counter(),
                       device=device)


CASES = [pytest.param(CELLS[0], "tiny", id="bert-tiny")] + [
    pytest.param(c, "cell", marks=pytest.mark.cuda, id=f"{c}-card")
    for c in CELLS]


@pytest.mark.parametrize("cell,size", CASES)
def test_program_reads_correct(tmp_path, cell, size):
    out = _run(_root(tmp_path, size), cell, _device(size))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,size", CASES)
def test_control_reads_not_correct(tmp_path, cell, size):
    device = _device(size)
    c = harness.Cell(_root(tmp_path, size), cell)
    prog = c.driver.Run(c.config, c.workload, SEED, device)
    prog.finish()
    checks = compare.judge(
        c.driver.gaps(prog.control_readings(), prog.reference_readings()),
        c.workload["limits"])
    assert not all(ch["ok"] for ch in checks), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell,size", CASES)
def test_planted_fault_reads_not_correct(tmp_path, cell, size, fault):
    root, device = _root(tmp_path, size), _device(size)
    with faults.planted(fault):
        out = _run(root, cell, device)
    assert not out["correct"], out["checks"]
