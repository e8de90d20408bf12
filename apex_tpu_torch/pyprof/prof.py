"""``pyprof.prof`` analog -- FLOPs/bytes attribution for one step.

Counterpart of the JAX package's ``apex_tpu/pyprof/prof.py``.  The
reference's ``apex/pyprof/prof`` maps captured GPU kernels back to torch
ops and hand-computes FLOPs/bytes per op class, so the user sees
arithmetic intensity and utilisation.  The port builds the report on
:func:`apex_tpu_torch.telemetry.attrib.op_table`: the step runs once under
a dispatch recording (FLOPs from ``torch.utils.flop_counter``'s formulas,
bytes as operand plus output bytes, one row per hand-kernel launch).

    from apex_tpu_torch.pyprof import prof
    rep = prof.cost_report(train_step, state, batch, cfg)
    print(prof.format_report(rep))

Derived metrics, as in the JAX report:

    flops              floating-point ops the recorded call did
    bytes_accessed     operand + output bytes of every recorded op
    arithmetic_intensity   flops / bytes_accessed (roofline x-coordinate)
    projected_ms       max(flops/peak_flops, bytes/peak_bw), the roofline
                       lower bound for the given hardware ceilings
    *_bytes            argument / output / temp bytes of the call

Divergences: the JAX report compiles the function and never runs it; this
one runs it once and has no compiler cost model (``code_bytes`` is 0).
The ceilings table holds the card's rows (``h100``, a generic ``gpu``) and
the ``cpu`` row the tests use; the JAX package's TPU rows are not the
port's hardware and are left out.

CLI (profiles the port's flagship transformer train step on the card):

    python -m apex_tpu_torch.pyprof.prof [--layers N] [--batch B]
        [--seq S] [--d-model D] [--run] [--device cuda]
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

# Per-device ceilings for the roofline projection when the caller does not
# pass their own.  ``ici_bw`` is the one-way per-link interconnect
# bandwidth a collective model divides wire bytes by, ``ici_alpha_s`` the
# per-hop launch latency, ``hbm_bytes`` the capacity, ``dcn_bw`` /
# ``dcn_alpha_s`` the network tier between hosts.
#
# h100: NVIDIA's published H100 SXM5 figures (data sheet, dense, no
# sparsity), for the card ``nvidia-smi --query-gpu=name,power.limit``
# reports as "NVIDIA H100 80GB HBM3, 700.00 W": 989 TFLOP/s bf16 / fp16,
# 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s both ways (450 GB/s each
# way).  A card set below 700 W runs slower under load.  The latency and
# network terms are the generic gpu row's.
HW_CEILINGS = {
    "h100": {"peak_flops": 989e12, "peak_bw": 3.35e12,
             "ici_bw": 450e9, "ici_alpha_s": 1e-6, "hbm_bytes": 80e9,
             "dcn_bw": 50e9, "dcn_alpha_s": 1e-5},
    "gpu": {"peak_flops": 1e14, "peak_bw": 1e12,
            "ici_bw": 300e9, "ici_alpha_s": 1e-6, "hbm_bytes": 80e9,
            "dcn_bw": 50e9, "dcn_alpha_s": 1e-5},
    "cpu": {"peak_flops": 1e11, "peak_bw": 2e10,
            "ici_bw": 1e10, "ici_alpha_s": 5e-5, "hbm_bytes": 64e9,
            "dcn_bw": 1e10, "dcn_alpha_s": 5e-5},
}

#: every key a ceilings row may carry (the override grammar rejects
#: anything else -- a typo'd override must fail loudly)
CEILING_KEYS = ("peak_flops", "peak_bw", "ici_bw", "ici_alpha_s",
                "hbm_bytes", "dcn_bw", "dcn_alpha_s", "num_slices")

ENV_CEILINGS = "APEX_TPU_CEILINGS"


def platform_of(device) -> str:
    """The ceilings row of ``device``: ``h100`` for a card whose name
    says H100, ``gpu`` for another card, ``cpu`` otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    return "h100" if "H100" in name else "gpu"


def calibrate_ceilings(base: dict, artifact: dict) -> dict:
    """Fold a measured plan artifact (a ``plan`` leg with a
    ``calibration_scale`` s = measured / predicted) into a ceilings row:
    rates divide by s, latencies multiply by it; a per-family table
    (``family_calibration``) moves the comm tier by the non-dp families'
    extra scale.  Raises ``ValueError`` without a measured plan leg."""
    leg = artifact
    for key in ("detail", "plan"):
        if isinstance(leg, dict) and key in leg:
            leg = leg[key]
    if not (isinstance(leg, dict) and leg.get("leg") == "plan"
            and isinstance(leg.get("calibration_scale"), (int, float))
            and leg["calibration_scale"] > 0):
        raise ValueError(
            "ceilings calibration needs a measured plan leg with a "
            "calibration_scale; got none")
    s = float(leg["calibration_scale"])
    out = dict(base)
    for k in ("peak_flops", "peak_bw", "ici_bw", "dcn_bw"):
        if k in out:
            out[k] = out[k] / s
    for k in ("ici_alpha_s", "dcn_alpha_s"):
        if k in out:
            out[k] = out[k] * s
    fams = leg.get("family_calibration")
    if isinstance(fams, dict):
        dp_s = fams.get("dp")
        comm_fams = [v for k, v in fams.items()
                     if k != "dp" and isinstance(v, (int, float)) and v > 0]
        if isinstance(dp_s, (int, float)) and dp_s > 0 and comm_fams:
            comm_ratio = (sum(comm_fams) / len(comm_fams)) / dp_s
            out["ici_bw"] = out["ici_bw"] / comm_ratio
            if "dcn_bw" in out:
                out["dcn_bw"] = out["dcn_bw"] / comm_ratio
    return out


def resolve_ceilings(platform: str = "cpu") -> dict:
    """The ceilings row for ``platform`` (``h100`` / ``gpu`` / ``cpu``),
    with the ``APEX_TPU_CEILINGS`` override applied.  Grammar
    (comma-separated tokens, applied left to right)::

        APEX_TPU_CEILINGS="h100"                  # named row
        APEX_TPU_CEILINGS="peak_flops=4.9e14"     # key override
        APEX_TPU_CEILINGS="h100,peak_bw=3e12"     # row, then override
        APEX_TPU_CEILINGS="h100,@PLAN.json"       # measured calibration
    """
    base = dict(HW_CEILINGS.get(platform, HW_CEILINGS["cpu"]))
    spec = os.environ.get(ENV_CEILINGS, "").strip()
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        if tok.startswith("@"):
            import json
            try:
                with open(tok[1:]) as f:
                    art = json.load(f)
            except (OSError, ValueError) as e:
                raise ValueError(
                    f"{ENV_CEILINGS}: cannot read calibration artifact "
                    f"{tok[1:]!r}: {e}") from None
            base = calibrate_ceilings(base, art)
        elif "=" in tok:
            key, _, val = tok.partition("=")
            key = key.strip()
            if key not in CEILING_KEYS:
                raise ValueError(
                    f"{ENV_CEILINGS}: unknown ceiling {key!r} "
                    f"(known: {CEILING_KEYS})")
            base[key] = float(val)
        else:
            if tok not in HW_CEILINGS:
                raise ValueError(
                    f"{ENV_CEILINGS}: unknown ceilings row {tok!r} "
                    f"(known: {tuple(sorted(HW_CEILINGS))})")
            base.update(HW_CEILINGS[tok])
    return base


def cost_report(fn: Callable, *args,
                peak_flops: Optional[float] = None,
                peak_bw: Optional[float] = None,
                **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a recording and return its
    cost: the JAX report's keys, from the per-op table and the liveness
    sweep of the same run."""
    from ..telemetry import attrib as _attrib
    from ..telemetry import memory as _memory
    dev = _attrib._device_of_args(args, kwargs)
    platform = platform_of(dev)
    ceil = resolve_ceilings(platform)
    pf = peak_flops or ceil["peak_flops"]
    pb = peak_bw or ceil["peak_bw"]
    _, rec = _attrib.record(fn, *args, liveness=True, **kwargs)
    live = _memory.liveness(rec, dev)
    flops = sum(r["flops"] for r in rec.rows)
    byts = sum(r["bytes"] for r in rec.rows)
    cls = live["by_class"]
    arg_bytes = sum(v for k, v in cls.items()
                    if k in ("params", "optimizer", "batch", "args"))
    return {
        "platform": platform,
        "cost_data_available": bool(flops or byts),
        "flops": flops,
        "bytes_accessed": byts,
        "transcendentals": sum(r["transcendentals"] for r in rec.rows),
        "arithmetic_intensity": (flops / byts) if byts else 0.0,
        "projected_ms": 1e3 * max(flops / pf, byts / pb) if (flops or byts)
                        else 0.0,
        "peak_flops": pf,
        "peak_bw": pb,
        "temp_bytes": float(cls.get("activations", 0) + cls.get("temps", 0)),
        "argument_bytes": float(arg_bytes),
        "output_bytes": float(cls.get("output", 0)),
        "code_bytes": 0.0,
        "n_ops": len(rec.rows),
    }


def _human(n: float, unit: str = "") -> str:
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= scale:
            return f"{n / scale:.2f} {suffix}{unit}"
    return f"{n:.0f} {unit}"


def format_report(rep: dict) -> str:
    """The reference's summary table shape, one step."""
    lines = [
        f"platform            {rep['platform']}",
        f"flops               {_human(rep['flops'], 'FLOP')}",
        f"bytes accessed      {_human(rep['bytes_accessed'], 'B')}",
        f"arith intensity     {rep['arithmetic_intensity']:.1f} FLOP/B",
        f"roofline projection {rep['projected_ms']:.3f} ms  "
        f"(ceilings: {_human(rep['peak_flops'], 'FLOP/s')}, "
        f"{_human(rep['peak_bw'], 'B/s')})",
        f"temp / args / out   {_human(rep['temp_bytes'], 'B')} / "
        f"{_human(rep['argument_bytes'], 'B')} / "
        f"{_human(rep['output_bytes'], 'B')}  (at the step's peak)",
    ]
    return "\n".join(lines)


def measured_vs_projected(fn: Callable, *args, iters: int = 10,
                          peak_flops: Optional[float] = None,
                          peak_bw: Optional[float] = None,
                          **kwargs) -> dict:
    """:func:`cost_report`, then ``iters`` timed calls: ``measured_ms``
    (host clock around calls that end in a device synchronize) and
    ``utilisation`` = projected / measured -- the reference's 'TC
    utilisation' column analog."""
    rep = cost_report(fn, *args, peak_flops=peak_flops, peak_bw=peak_bw,
                      **kwargs)
    from ..telemetry.attrib import _device_of_args
    on_card = _device_of_args(args, kwargs).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    sync()
    ms = (time.perf_counter() - t0) / iters * 1e3
    rep["measured_ms"] = ms
    rep["utilisation"] = (rep["projected_ms"] / ms) if ms else 0.0
    return rep


def _main(argv=None) -> int:
    import argparse

    from .. import amp
    from ..models import TransformerConfig, transformer_init
    from ..optimizers import FusedAdam
    from ..train import train_step
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="default: cuda (the card)")
    p.add_argument("--run", action="store_true",
                   help="also run it and report measured ms + utilisation")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = TransformerConfig(vocab_size=1024, max_len=args.seq,
                            num_layers=args.layers, d_model=args.d_model,
                            num_heads=4, d_ff=4 * args.d_model,
                            dtype=torch.bfloat16)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    state = amp.initialize(params, FusedAdam(lr=1e-4, impl="fused"),
                           opt_level="O5", verbosity=0)
    batch = {"tokens": torch.zeros((args.batch, args.seq), dtype=torch.int64,
                                   device=dev),
             "targets": torch.zeros((args.batch, args.seq),
                                    dtype=torch.int64, device=dev)}
    fn = measured_vs_projected if args.run else cost_report
    rep = fn(train_step, state, batch, cfg)
    if dev.type == "cuda":
        print(f"device              {torch.cuda.get_device_name(dev)}")
    print(format_report(rep))
    if args.run:
        print(f"measured            {rep['measured_ms']:.3f} ms"
              f"  ({100 * rep['utilisation']:.1f}% of roofline)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
