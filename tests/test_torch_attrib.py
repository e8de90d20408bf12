"""The port's per-op cost attribution (``apex_tpu_torch.telemetry.attrib``)
against the JAX package's op classes, closed-form counts and
``torch.utils.flop_counter``.

The JAX ``op_table`` reads a compiled XLA-CPU module, whose cost model
varies between hosts, so the port is not held to its numbers.  It is held
to: the JAX ``op_class`` on pairs of ops that compute the same thing
(``mm`` / ``dot``, ``convolution`` / ``convolution``, ``sum`` /
``reduce``, ``tanh`` / ``tanh``, ``t`` / ``transpose``, a hand-kernel
launch / ``custom-call``, ``c10d.allreduce_`` / ``all-reduce``), exact
equality; the closed-form count of a product, 2·M·N·K; and
``FlopCounterMode``'s count of the same call, exact (the same formulas
on the same shapes), on a 2-layer, 64-wide O5 BERT step on the CPU.  A
hand-kernel launch reported inside a recording is one ``other`` row
(FLOPs 0, operand plus output bytes), also from an autograd backward; a
launch outside any recording, or in another thread's, adds none.
``collectives_table`` gives the JAX sub-table on the same rows.
"""
import threading

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from apex_tpu.telemetry import attrib as jax_attrib

from apex_tpu_torch import amp
from apex_tpu_torch.models import TransformerConfig, transformer_init
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.pyprof import prof as port_prof
from apex_tpu_torch.telemetry import attrib as port_attrib
from apex_tpu_torch.train import train_step
from apex_tpu_torch.utils import build

from _torch_port import amp_uninit  # noqa: F401

PAIRS = [("mm", "dot"), ("aten.addmm.default", "dot"), ("bmm", "dot"),
         ("convolution", "convolution"),
         ("convolution_backward", "convolution"),
         ("sum", "reduce"), ("amax", "reduce"), ("tanh", "tanh"),
         ("add_", "add"), ("mul", "multiply"), ("t", "transpose"),
         ("copy_", "copy"), ("_to_copy", "convert"), ("cat", "concatenate"),
         ("index", "gather"), ("flash_fwd", "custom-call"),
         ("lamb_stage1", "custom-call"), ("c10d.allreduce_", "all-reduce"),
         ("_c10d_functional.all_gather_into_tensor", "all-gather"),
         ("sort", "sort")]


def test_op_classes_are_the_jax_vocabulary():
    assert port_attrib.OP_CLASSES == jax_attrib.OP_CLASSES


@pytest.mark.parametrize("port_op,hlo_op", PAIRS)
def test_op_class_pairs_equal_jax(port_op, hlo_op):
    assert port_attrib.op_class(port_op) == jax_attrib.op_class(hlo_op)


def test_hlo_op_class_is_the_jax_binning():
    for op in ("dot", "convolution", "reduce", "reduce-window", "all-reduce",
               "collective-permute", "copy", "transpose", "broadcast",
               "dynamic-update-slice", "custom-call", "while", "fusion",
               "add", "tanh", "select"):
        assert port_attrib.hlo_op_class(op) == jax_attrib.op_class(op)


@pytest.mark.parametrize("m,k,n", [(8, 16, 32), (5, 7, 3)])
def test_matmul_row_is_the_closed_form(m, k, n):
    a, b = torch.randn(m, k), torch.randn(k, n)
    table = port_attrib.op_table(lambda x, y: x @ y, a, b)
    mm = [r for r in table["rows"] if r["opcode"] == "mm"]
    assert len(mm) == 1
    assert mm[0]["flops"] == 2.0 * m * n * k
    assert mm[0]["class"] == "blas"
    assert mm[0]["bytes"] == 4.0 * (m * k + k * n + m * n)
    assert mm[0]["out_bytes"] == 4.0 * m * n
    assert table["by_class"]["blas"]["flops"] == 2.0 * m * n * k


def _o5():
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
    return st, batch, cfg


def test_o5_step_blas_flops_equal_flop_counter_mode():
    st, batch, cfg = _o5()
    table = port_attrib.op_table(train_step, st, batch, cfg)
    fc = FlopCounterMode(display=False)
    with fc:
        train_step(st, batch, cfg)
    assert table["by_class"]["blas"]["flops"] == fc.get_total_flops() > 0
    assert table["platform"] == "cpu"
    assert table["total_flops"] == sum(r["flops"] for r in table["rows"])
    assert set(table) == {"platform", "rows", "collectives", "by_opcode",
                          "by_class", "total_flops", "total_bytes",
                          "module_flops", "module_bytes", "peak_flops",
                          "peak_bw"}
    text = port_attrib.format_op_table(table, top=5)
    assert "per-class rollup" in text and "blas" in text


def test_cost_report_totals_are_the_op_tables():
    st, batch, cfg = _o5()
    rep = port_prof.cost_report(train_step, st, batch, cfg)
    table = port_attrib.op_table(train_step, st, batch, cfg)
    assert rep["flops"] == table["total_flops"]
    assert rep["bytes_accessed"] == table["total_bytes"]
    assert rep["projected_ms"] == pytest.approx(1e3 * max(
        rep["flops"] / rep["peak_flops"],
        rep["bytes_accessed"] / rep["peak_bw"]))
    assert "roofline projection" in port_prof.format_report(rep)


class _KernelFn(torch.autograd.Function):
    """Stands in for a hand kernel's wrapper: reports a launch forward and
    backward, as the ctypes wrappers do on the card."""

    @staticmethod
    def forward(ctx, x):
        out = x * 2.0
        build.launched("ln_fwd", x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        dx = g * 2.0
        build.launched("ln_bwd", g, dx)
        return dx


def test_kernel_launches_are_rows_forward_and_backward():
    x = torch.randn(4, 8, requires_grad=True)
    before = dict(build.LAUNCHES)

    def step(x):
        y = _KernelFn.apply(x)
        (g,) = torch.autograd.grad(y.sum(), x)
        return g

    table = port_attrib.op_table(step, x)
    rows = [r for r in table["rows"] if r["class"] == "other"]
    assert sorted(r["opcode"] for r in rows) == ["ln_bwd", "ln_fwd"]
    for r in rows:
        assert r["flops"] == 0.0 and r["bytes"] == 2 * 4 * 8 * 4
    assert build.LAUNCHES["ln_fwd"] == before.get("ln_fwd", 0) + 1
    assert build.LAUNCHES["ln_bwd"] == before.get("ln_bwd", 0) + 1
    # outside a recording a launch only counts
    _KernelFn.apply(x)
    assert build.LAUNCHES["ln_fwd"] == before.get("ln_fwd", 0) + 2


def test_another_threads_launches_stay_out_of_a_recording():
    started, release = threading.Event(), threading.Event()

    def worker():
        started.wait()
        build.launched("xent_fwd", torch.zeros(3))
        release.set()

    t = threading.Thread(target=worker)
    t.start()

    def fn():
        started.set()
        release.wait(10)
        return torch.ones(2) + 1

    table = port_attrib.op_table(fn)
    t.join()
    assert not [r for r in table["rows"] if r["class"] == "other"]


def test_collectives_table_equals_jax():
    rows = [{"op": "c10d.allreduce_.0", "opcode": "c10d.allreduce_",
             "class": "collective", "jax_op": "", "bytes": 64.0,
             "out_bytes": 32.0},
            {"op": "_c10d_functional.all_gather_into_tensor.1",
             "opcode": "_c10d_functional.all_gather_into_tensor",
             "class": "collective", "jax_op": "", "bytes": 40.0,
             "out_bytes": 32.0},
            {"op": "mm.2", "opcode": "mm", "class": "blas", "jax_op": "",
             "bytes": 100.0, "out_bytes": 10.0}]
    assert port_attrib.collectives_table(rows) == \
        jax_attrib.collectives_table(rows)
