"""Render a telemetry JSONL run into the step-metrics summary, and the
``python -m apex_tpu_torch.telemetry`` CLI.

Counterpart of the JAX package's ``apex_tpu/telemetry/report.py``:
:func:`load_records`, :func:`summarize` and :func:`format_summary` keep its
summary keys; ``python -m apex_tpu_torch.telemetry run.jsonl`` prints
step-time stats, items/sec, overflow events + final loss scale,
collective bytes/calls and loader wait.  With no path it runs the demo
(:func:`run_demo`): the port's transformer under amp O5 + FusedAdam,
instrumented through the real registry/event wiring, with an amp
overflow forced on one step, then the per-op FLOPs/bytes table
(:mod:`.attrib`) of the same step.  Subcommands ``trace``, ``goodput``,
``mem``, ``serve``, ``timeline`` and ``fleet`` render the other artifacts;
``control`` (the JAX package's run controller) is not ported yet and
exits 2.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from . import registry as _registry


def load_records(path: str, validate: bool = False) -> List[dict]:
    """Parse a JSONL telemetry file.  ``validate=True`` raises on the
    first off-schema record (the round-trip test path); otherwise bad
    lines are skipped.
    """
    out: List[dict] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if validate:
                    raise ValueError(f"{path}:{ln}: not JSON")
                continue
            bad = _registry.record_violations(rec)
            if bad:
                if validate:
                    raise ValueError(f"{path}:{ln}: {'; '.join(bad)}")
                continue
            out.append(rec)
    return out


def _combine_hist(records: List[dict]) -> Optional[dict]:
    """Merge windowed histogram records into run-level stats."""
    stats = [r["stats"] for r in records]
    if not stats:
        return None
    count = sum(s["count"] for s in stats)
    total = sum(s["sum"] for s in stats)
    return {"count": count, "sum": total,
            "min": min(s["min"] for s in stats),
            "max": max(s["max"] for s in stats),
            "mean": total / count if count else 0.0}


def summarize(records: List[dict]) -> dict:
    """Aggregate a record list into the run summary dict."""
    metrics: Dict[str, List[dict]] = {}
    events: Dict[str, List[dict]] = {}
    steps = 0
    for rec in records:
        if rec.get("kind") == "metric":
            metrics.setdefault(rec["name"], []).append(rec)
            steps = max(steps, rec.get("step", 0))
        elif rec.get("kind") == "event":
            events.setdefault(rec["name"], []).append(rec)
            steps = max(steps, rec.get("step", 0))

    def counter_final(name):
        recs = [r for r in metrics.get(name, ()) if r["type"] == "counter"]
        return recs[-1]["value"] if recs else 0.0

    def gauge_last(name):
        recs = [r for r in metrics.get(name, ()) if r["type"] == "gauge"]
        return recs[-1]["value"] if recs else None

    def gauge_max(name):
        vals = [r["value"] for r in metrics.get(name, ())
                if r["type"] == "gauge"]
        return max(vals) if vals else None

    def hist(name):
        return _combine_hist([r for r in metrics.get(name, ())
                              if r["type"] == "histogram"])

    step_time = hist("step_time_ms")
    mem_peak = gauge_max("mem.peak_bytes_in_use")
    if mem_peak is None:
        mem_peak = gauge_max("mem.compiled_peak_bytes")
    # collective accounting spans the DDP allreduce, the ZeRO
    # reduce-scatter/allgather meters, and the DDP weight-update-
    # sharding reduce-scatter/param-allgather; ``wire`` is what the
    # selected collective scheme actually shipped —
    # absent compressed counters (pre-compression JSONLs) degrade to
    # wire == logical
    # ... plus the SPMD engine's model-parallel families (tp.psum from
    # the compiled-HLO meter, sp.all_to_all/sp.ppermute from the
    # sequence-parallel collectives — parallel.spmd)
    _coll_ops = ("ddp.allreduce", "zero.reduce_scatter", "zero.allgather",
                 "ddp.reduce_scatter", "ddp.param_allgather",
                 "tp.psum", "sp.all_to_all", "sp.ppermute")
    coll_logical = sum(counter_final(f"{n}_bytes") for n in _coll_ops)
    coll_wire = sum(counter_final(f"{n}_compressed_bytes")
                    for n in _coll_ops) or coll_logical
    out = {
        "steps": steps,
        "step_time_ms": step_time,
        "overflow_events": len(events.get("amp.overflow", ())),
        "scale_doublings": len(events.get("amp.loss_scale_doubled", ())),
        "loss_scale": gauge_last("amp.loss_scale"),
        "collective_bytes": coll_logical,
        "collective_wire_bytes": coll_wire,
        "collective_calls": sum(counter_final(f"{n}_calls")
                                for n in _coll_ops),
        "loader_queue_depth": gauge_last("loader.queue_depth"),
        "loader_wait_ms": hist("loader.wait_ms"),
        # resilience lifecycle: the guard emits
        # these through the same registry, so a run that injected
        # faults / rolled back / resumed shows it in the summary
        # instead of silently dropping the events
        "faults_injected": len(events.get("fault_injected", ())),
        "rollbacks": len(events.get("rollback", ())),
        "resumes": len(events.get("resumed", ())),
        "preemptions": len(events.get("preempted", ())),
        "sentinel_fires": len(events.get("sentinel.slow_step", ())),
        # elastic lifecycle: a run
        # that crossed a chip-count change shows its reshards/replans
        # on the same resilience line
        "reshards": len(events.get("elastic.reshard", ())),
        "replans": len(events.get("elastic.replan", ())),
        # data plane: loader stall retries that healed
        # (or preceded an escalation), shard-checksum failures, and
        # elastic N->M shard re-partitions — the seekable data plane's
        # recovery history on the same resilience line
        "loader_retries": len(events.get("loader.retry", ())),
        "shard_checksum_failures": len(
            events.get("data.checksum_failed", ())),
        "data_repartitions": len(
            events.get("elastic.data_repartition", ())),
        # memory: live allocator high-water
        # from the monitor's mem.* gauges (max over the run — a gauge's
        # last value would under-report a mid-run spike), the
        # compiled-model peak bench legs embed, and the guard's OOM
        # post-mortem events
        "mem_peak_bytes": mem_peak,
        "mem_in_use_bytes": gauge_last("mem.bytes_in_use"),
        "oom_events": len(events.get("memory.oom", ())),
        # goodput: the run ledger's
        # exported gauges — wall-clock fraction that was productive
        # training, plus the per-class badput breakdown in ms
        "goodput_fraction": gauge_last("goodput.fraction"),
        # control: the run controller's decision
        # events — actions taken, breaches suppressed by the
        # cooldown/max-actions gates, and actions that failed and
        # reverted — folded next to the resilience line so a run the
        # controller steered shows it in the same summary
        "control_actions": len(events.get("control.decision", ())),
        "control_suppressed": len(events.get("control.suppressed", ())),
        "control_failed": len(events.get("control.action_failed", ())),
        # serving: the per-request latency ledger's
        # exported gauges — request counts (served/shed), tail latency,
        # and decode throughput, mirrored next to the train-side lines
        "serve_requests_served": gauge_last("serve.requests_served"),
        "serve_requests_shed": gauge_last("serve.requests_shed"),
        "serve_p50_ms": gauge_last("serve.p50_ms"),
        "serve_p99_ms": gauge_last("serve.p99_ms"),
        "serve_tokens_per_sec": gauge_last("serve.tokens_per_sec"),
        "badput_ms": {
            name[len("badput."):-len("_ms")]: recs[-1]["value"]
            for name, recs in metrics.items()
            if name.startswith("badput.") and name.endswith("_ms")
            and recs and recs[-1]["type"] == "gauge"},
    }
    examples = counter_final("examples") or counter_final("tokens")
    if examples and step_time and step_time["sum"]:
        out["items_total"] = examples
        out["items_per_sec"] = examples / (step_time["sum"] / 1e3)
    if steps:
        out["overflow_rate"] = out["overflow_events"] / steps
    return out


def _fmt_hist(h: Optional[dict], unit: str = "ms") -> str:
    if not h:
        return "n/a"
    return (f"mean {h['mean']:.3f} {unit}  min {h['min']:.3f}  "
            f"max {h['max']:.3f}  (n={h['count']})")


def format_summary(s: dict) -> str:
    lines = [
        "step-metrics summary",
        f"  steps               {s['steps']}",
        f"  step time           {_fmt_hist(s['step_time_ms'])}",
    ]
    if "items_per_sec" in s:
        lines.append(f"  throughput          {s['items_per_sec']:.1f} "
                     f"items/sec ({s['items_total']:.0f} total)")
    lines.append(f"  overflow events     {s['overflow_events']}"
                 + (f"  (rate {s['overflow_rate']:.3f}/step)"
                    if "overflow_rate" in s else ""))
    lines.append(f"  scale doublings     {s['scale_doublings']}")
    if s["loss_scale"] is not None:
        lines.append(f"  final loss scale    {s['loss_scale']:.0f}")
    wire = s.get("collective_wire_bytes")
    if wire is not None and wire != s["collective_bytes"]:
        ratio = s["collective_bytes"] / wire if wire else 1.0
        lines.append(f"  collective bytes    {s['collective_bytes']:.0f} "
                     f"logical / {wire:.0f} wire ({ratio:.2f}x compression, "
                     f"{s['collective_calls']:.0f} calls)")
    else:
        lines.append(f"  collective bytes    {s['collective_bytes']:.0f} "
                     f"({s['collective_calls']:.0f} calls)")
    if s["loader_queue_depth"] is not None:
        lines.append(f"  loader queue depth  {s['loader_queue_depth']:.0f}"
                     f" (last)")
    lines.append(f"  loader wait         {_fmt_hist(s['loader_wait_ms'])}")
    res = [(k, s.get(k, 0)) for k in ("faults_injected", "rollbacks",
                                      "resumes", "preemptions",
                                      "sentinel_fires", "reshards",
                                      "replans", "loader_retries",
                                      "shard_checksum_failures",
                                      "data_repartitions")]
    if any(n for _, n in res):
        lines.append("  resilience          "
                     + "  ".join(f"{k.replace('_', ' ')} {n}"
                                 for k, n in res if n))
    if s.get("mem_peak_bytes") is not None or s.get("oom_events"):
        from .memory import _human as _hb
        parts = []
        if s.get("mem_peak_bytes") is not None:
            parts.append(f"peak {_hb(s['mem_peak_bytes'], 'B')}")
        if s.get("mem_in_use_bytes") is not None:
            parts.append(f"in-use {_hb(s['mem_in_use_bytes'], 'B')}")
        parts.append(f"oom events {s.get('oom_events', 0)}")
        lines.append("  memory              " + "  ".join(parts))
    if s.get("goodput_fraction") is not None:
        bad = [(k, v) for k, v in sorted((s.get("badput_ms") or {}).items())
               if v]
        lines.append(f"  goodput             fraction "
                     f"{s['goodput_fraction']:.3f}"
                     + ("  badput: " + "  ".join(
                         f"{k.replace('_', ' ')} {v:.1f}ms"
                         for k, v in bad) if bad else ""))
    ctl = [(k, s.get(k, 0)) for k in ("control_actions",
                                      "control_suppressed",
                                      "control_failed")]
    if any(n for _, n in ctl):
        lines.append("  control             "
                     + "  ".join(f"{k[len('control_'):].replace('_', ' ')}"
                                 f" {n}" for k, n in ctl if n))
    if s.get("serve_requests_served") is not None:
        parts = [f"served {s['serve_requests_served']:.0f}",
                 f"shed {s.get('serve_requests_shed') or 0:.0f}"]
        if s.get("serve_p50_ms") is not None:
            parts.append(f"p50 {s['serve_p50_ms']:.1f}ms")
        if s.get("serve_p99_ms") is not None:
            parts.append(f"p99 {s['serve_p99_ms']:.1f}ms")
        if s.get("serve_tokens_per_sec") is not None:
            parts.append(f"{s['serve_tokens_per_sec']:.1f} tok/s")
        lines.append("  serving             " + "  ".join(parts))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the CLI demo: instrument the port's transformer train step
# ---------------------------------------------------------------------------

def demo_step_fn(layers: int = 2, batch: int = 4, seq: int = 32,
                 d_model: int = 64, device=None):
    """(train_step, state, make_batch) for the port's transformer at a
    small config under amp O5 + FusedAdam with a dynamic loss scale (so
    the forced-inf step halves it), on ``device`` (default ``"cuda"``).
    ``train_step(state, tokens, targets, boost)`` returns the new state
    and the loss; ``boost`` multiplies the loss (inf forces an
    overflow)."""
    import torch

    from .. import amp
    from ..models.transformer import (TransformerConfig, transformer_init,
                                      transformer_loss)
    from ..optimizers import FusedAdam
    from ..utils.device import resolve_device
    from ..utils.pytree import tree_flatten, tree_unflatten

    dev = resolve_device(device)
    cfg = TransformerConfig(vocab_size=256, max_len=seq, num_layers=layers,
                            d_model=d_model, num_heads=4, d_ff=4 * d_model,
                            dtype=torch.bfloat16)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    state = amp.initialize(params, FusedAdam(lr=1e-4), opt_level="O5",
                           loss_scale="dynamic", verbosity=0)

    def train_step(state, tokens, targets, boost):
        leaves, treedef = tree_flatten(state.model_params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = transformer_loss(tree_unflatten(treedef, leaves),
                                {"tokens": tokens, "targets": targets}, cfg)
        grads = torch.autograd.grad(
            amp.scale_loss(loss * boost, state), leaves)
        return (amp.amp_step(state, tree_unflatten(treedef, list(grads))),
                loss.detach())

    def make_batch(step):
        import numpy as np
        rng = np.random.RandomState(step)
        toks = torch.from_numpy(rng.randint(0, 256, (batch, seq))).to(
            dev, torch.int64)
        return toks, toks

    return train_step, state, make_batch


def run_demo(path: str, steps: int = 6, overflow_at: int = 3,
             flush_interval: int = 2, **cfg_kw) -> dict:
    """Drive the instrumented train step, write the JSONL to ``path``,
    and return the summary dict.  Step ``overflow_at`` feeds an inf loss
    boost so the amp overflow event wiring is exercised; each batch's
    wait is metered through ``events.record_loader``."""
    import time

    import torch

    from . import events as _events

    train_step, state, make_batch = demo_step_fn(**cfg_kw)
    reg = _registry.Registry(sink=_registry.JsonlSink(path),
                             flush_interval=flush_interval,
                             rank0_only=False, run_id="telemetry-demo")
    prev_default = _events.set_default(reg)
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            tokens, targets = make_batch(i)
            _events.record_loader(None, time.perf_counter() - t0)
            boost = torch.full((), float("inf") if i == overflow_at
                               else 1.0, device=tokens.device)
            with reg.step():
                prev = state
                state, loss = train_step(state, tokens, targets, boost)
                reg.gauge("loss").set(loss)
                reg.counter("examples").add(tokens.shape[0])
            _events.observe_amp(reg, prev, state)
        reg.close()
    finally:
        _events.set_default(prev_default)
    return summarize(load_records(path))


#: the JAX CLI's subcommands whose modules the port does not have yet
_NOT_PORTED = ("control",)


def main(argv=None) -> int:
    import argparse
    import os
    import sys
    import tempfile

    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        from . import trace as _trace
        return _trace.cli(argv[1:])
    if argv and argv[0] == "mem":
        from . import memory as _memory
        return _memory.cli(argv[1:])
    if argv and argv[0] == "goodput":
        from . import goodput as _goodput
        return _goodput.cli(argv[1:])
    if argv and argv[0] == "serve":
        from . import serve_ledger as _serve_ledger
        return _serve_ledger.cli(argv[1:])
    if argv and argv[0] == "timeline":
        from . import timeline as _timeline
        return _timeline.cli(argv[1:])
    if argv and argv[0] == "fleet":
        from . import fleet as _fleet
        return _fleet.cli(argv[1:])
    if argv and argv[0] in _NOT_PORTED:
        print(f"python -m apex_tpu_torch.telemetry {argv[0]}: not ported "
              "yet (the JAX package's telemetry.{argv[0]} has no "
              "counterpart in the port)", file=sys.stderr)
        return 2

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry",
        description=__doc__.splitlines()[0])
    ap.add_argument("jsonl", nargs="?", default=None,
                    help="telemetry JSONL to render; omit to run the "
                         "instrumented-transformer demo")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="the demo's device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="demo JSONL destination (default: temp file)")
    ap.add_argument("--top", type=int, default=15,
                    help="rows in the per-op table")
    ap.add_argument("--no-attrib", action="store_true",
                    help="skip the per-op table (summary only)")
    args = ap.parse_args(argv)

    if args.jsonl is not None:
        summary = summarize(load_records(args.jsonl))
        print(format_summary(summary))
        return 0

    path = args.out or os.path.join(
        tempfile.mkdtemp(prefix="apex_tpu_torch_telemetry_"), "demo.jsonl")
    cfg = dict(layers=args.layers, batch=args.batch, seq=args.seq,
               device=args.device)
    summary = run_demo(path, steps=args.steps, **cfg)
    if not args.no_attrib:
        import torch
        from . import attrib
        train_step, state, make_batch = demo_step_fn(**cfg)
        tokens, targets = make_batch(0)
        table = attrib.op_table(train_step, state, tokens, targets,
                                torch.ones((), device=tokens.device))
        print(attrib.format_op_table(table, top=args.top))
        print()
    print(format_summary(summary))
    print(f"\nrecords: {path}")
    return 0
