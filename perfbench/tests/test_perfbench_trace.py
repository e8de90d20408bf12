"""The reduction of a trace to the per-layer readers' numbers, on a
trace written by hand."""
import pytest

from perfbench.lib import readers, trace


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    return [
        _ev("user_annotation", trace.WINDOW, 100.0, 1000.0),
        _ev("kernel", "void flash_fwd_sm90_kernel<bf16, 64, 2>(x)", 50.0,
            20.0, 0),                               # before the window
        _ev("user_annotation", trace.AMP_STEP, 500.0, 100.0),
        _ev("cpu_op", "aten::mm", 110.0, 10.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 112.0, 2.0, 1),
        _ev("kernel", "void flash_fwd_sm90_kernel<bf16, 64, 2>(x)", 120.0,
            100.0, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 130.0, 2.0, 2),
        _ev("kernel", "nvjet_gemm", 200.0, 100.0, 2),     # overlaps 200-220
        _ev("cpu_op", "aten::copy_", 300.0, 250.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 510.0, 2.0, 3),
        _ev("kernel", "elementwise_kernel", 600.0, 50.0, 3),
        _ev("cuda_runtime", "cudaMemsetAsync", 590.0, 2.0, 4),
        _ev("gpu_memset", "Memset", 700.0, 10.0, 4),
        _ev("cpu_op", "aten::item", 800.0, 300.0),
    ]


def _reduce(events=None):
    names = {"flash_fwd_sm90_kernel": "flash_fwd"}

    def launch(k):
        return next((v for f, v in names.items() if f in k), None)
    return trace.reduce_events(events or _events(), 2, {"flash_fwd": 1},
                               launch, lambda k: launch(k) is not None)


def test_busy_idle_and_kernel_sums():
    r = _reduce()
    assert r["window_s"] == pytest.approx(1000e-6)
    # union: 120-300, 600-650, 700-710 -> 240 us
    assert r["busy_s"] == pytest.approx(240e-6)
    assert r["port_kernel_s"] == {"flash_fwd": pytest.approx(100e-6)}
    assert r["other_kernel_s"] == pytest.approx(150e-6)
    # amp_step launched the 600-650 kernel and the 700-710 memset
    assert r["amp_step_spans_s"] == [pytest.approx(110e-6)]
    rec = {"trace": r, "flops_per_step": 989e12 * 1e-4,
           "kernel_shapes": {}}
    assert readers.device_idle_pct(rec) == pytest.approx(76.0)
    assert readers.amp_step_ms(rec) == pytest.approx(0.11)
    assert readers.torch_kernel_ms(rec) == pytest.approx(0.075)
    assert readers.step_mfu(rec) == pytest.approx(100.0 * 2e-4 / 1e-3)


def test_breakdown_names_gaps_by_host_operation():
    gaps = _reduce()["breakdown"]["idle_gaps"]
    # 710-1100 under aten::item, 300-600 under aten::copy_, 650-700 under
    # no host operation, 100-120 under aten::mm
    assert gaps == [["aten::item", pytest.approx(390e-6)],
                    ["aten::copy_", pytest.approx(300e-6)],
                    ["no host operation", pytest.approx(50e-6)],
                    ["aten::mm", pytest.approx(20e-6)]]


def test_roofline_reads_launch_counts_and_kernel_time():
    r = _reduce()
    shapes = {"flash": {"bh": 1, "s": 1024, "d": 64, "dtype": "bfloat16",
                        "bias_elems": 1024}}
    got = readers.roofline({"trace": r, "kernel_shapes": shapes}, "flash")
    bound = readers._flash_bound_s("flash_fwd", shapes["flash"])
    assert got == pytest.approx(100.0 * bound / 100e-6)
    assert readers.roofline({"trace": r, "kernel_shapes": {}}, "flash") \
        is None


def test_a_window_with_no_kernel_fails():
    events = [e for e in _events() if e["cat"] != "kernel"]
    with pytest.raises(RuntimeError):
        _reduce(events)
