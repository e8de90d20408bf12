"""What the metric readers share.  A reader takes the run's record and
returns a number, or None where the run holds nothing for it: a rate
reads the untraced window, the rest the traced one (``rec["trace"]``,
:func:`perfbench.lib.trace.reduce_events`)."""
from __future__ import annotations

from typing import Optional

from perfbench.lib import frozen

PEAK_DTYPE = "bfloat16"


def rate(rec: dict, unit: str) -> Optional[float]:
    """Items of every step the window completed over its wall time."""
    if rec.get("item_unit") != unit or "window_s" not in rec:
        return None
    return rec["steps"] * rec["items_per_step"] / rec["window_s"]


def step_mfu(rec: dict) -> Optional[float]:
    """The model FLOPs of the traced window's steps over its wall time, as
    a share of the card's bf16 dense peak (%)."""
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    return 100.0 * rec["flops_per_step"] * t["steps"] / t["window_s"] \
        / frozen.PEAK_FLOPS[PEAK_DTYPE]


def amp_step_ms(rec: dict) -> Optional[float]:
    """Mean device span of ``amp_step``: first to last device operation it
    launched."""
    t = rec.get("trace")
    if not t or not t["amp_step_spans_s"]:
        return None
    spans = t["amp_step_spans_s"]
    return 1e3 * sum(spans) / len(spans)


def torch_kernel_ms(rec: dict) -> Optional[float]:
    """Device ms a step of every kernel that is not the port's own."""
    t = rec.get("trace")
    if not t or not t["steps"] or not t["other_kernel_s"]:
        return None
    return 1e3 * t["other_kernel_s"] / t["steps"]


def device_idle_pct(rec: dict) -> Optional[float]:
    t = rec.get("trace")
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _flash_bound_s(name: str, s: dict) -> float:
    bh, n, d, dt, bias = s["bh"], s["s"], s["d"], s["dtype"], s["bias_elems"]
    if name == "flash_fwd":
        nbytes, flops = frozen.flash_fwd_counts(bh, n, n, d, dt, bias)
    elif name == "flash_bwd":
        nbytes, flops = frozen.flash_bwd_counts(bh, n, n, d, dt, bias)
    elif name == "flash_bwd_dq":
        nbytes, flops = frozen.flash_bwd_dq_counts(bh, n, d, dt, bias)
    else:
        nbytes, flops = frozen.flash_bwd_dkv_counts(bh, n, d, dt, bias)
    return frozen.bound_s(nbytes, flops, dt)


def _ln_bound_s(name: str, s: dict) -> float:
    counts = frozen.ln_fwd_counts if name == "ln_fwd" else frozen.ln_bwd_counts
    nbytes, flops = counts(s["n"], s["h"], s["dtype"])
    return frozen.bound_s(nbytes, flops, frozen.KERNEL_BOUND_DTYPE[name])


_BOUNDS = {"flash": (("flash_fwd", "flash_bwd", "flash_bwd_dq",
                      "flash_bwd_dkv"), _flash_bound_s),
           "layer_norm": (("ln_fwd", "ln_bwd"), _ln_bound_s)}


def roofline(rec: dict, family: str) -> Optional[float]:
    """Σ bound over Σ device time of every launch of the family's kernels
    in the traced window (%); the launches are the port's counts, the
    bounds those of the cell's shapes."""
    t = rec.get("trace")
    shapes = rec.get("kernel_shapes", {}).get(family)
    if not t or shapes is None:
        return None
    names, bound = _BOUNDS[family]
    spent = sum(t["port_kernel_s"].get(n, 0.0) for n in names)
    need = sum(t["launches"].get(n, 0) * bound(n, shapes) for n in names)
    if spent <= 0.0 or need <= 0.0:
        return None
    return 100.0 * need / spent
