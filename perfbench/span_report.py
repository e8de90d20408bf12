"""The span table of one traced run of a cell: device ms a step by owner
(``lib/spans.py``), forward and backward apart, with each owner's top
kernels (each named with the op that launched it and, in the backward,
the autograd node), the step spans opened a step, and the window's
widest idle gaps with the step spans the host's main thread was in.

    python3 perfbench/span_report.py --workload bert_large.pretrain_s512 \\
        --seed 7 --seconds 10 [--out report.json]

Run from the root of a checkout, on the cell's card.  Prints the table
and, with ``--out``, writes it as JSON."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOP = 3


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _labels(events, device) -> list:
    """Each device operation as ``[node /] op: kernel``: the innermost host
    op around its launch and, in the backward, the autograd node."""
    from perfbench.lib import spans, trace
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in trace.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ops = spans._Threads(e for e in events if e.get("cat") == "cpu_op"
                         and "dur" in e)
    found = [launches.get(e.get("args", {}).get("correlation"))
             for e in device]
    chains = iter(ops.chains([(spans._thread(l), float(l["ts"]))
                              for l in found if l is not None]))
    out = []
    for e, launch in zip(device, found):
        chain = next(chains) if launch is not None else ()
        node = [r["name"][len(spans.BACKWARD_ROW):].strip() for r in chain
                if spans._is_backward(r)]
        op = [r["name"] for r in chain if not spans._is_backward(r)]
        head = " / ".join(node[-1:] + op[-1:])
        out.append(_short(f"{head}: {e['name']}" if head else e["name"]))
    return out


def report(events, steps: int, names) -> dict:
    """The table of a traced window's events."""
    from perfbench.lib import spans, trace
    rows: dict = {}
    kernels: dict = {}
    owned = spans.attribute(events, names)
    labels = _labels(events, [e for e, _, _ in owned])
    for (e, path, backward), label in zip(owned, labels):
        r = rows.setdefault(path, {"forward_ms": 0.0, "backward_ms": 0.0})
        r["backward_ms" if backward else "forward_ms"] += \
            float(e["dur"]) * 1e-3 / steps
        k = kernels.setdefault(path, {})
        k[label] = k.get(label, 0.0) + float(e["dur"]) * 1e-3 / steps
    for path, k in kernels.items():
        rows[path]["top"] = [[n, ms] for n, ms in sorted(
            k.items(), key=lambda kv: -kv[1])[:TOP]]
    win = next(e for e in events if e.get("name") == trace.WINDOW
               and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    opened = sum(1 for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") in set(names)
                 and w0 <= float(e["ts"]) < w1)
    busy = trace._union([(float(e["ts"]), min(float(e["ts"])
                                              + float(e["dur"]), w1))
                         for e in events if e.get("cat") in trace.DEVICE_CATS
                         and w0 <= float(e["ts"]) < w1])
    edges = [w0] + [x for s in busy for x in s] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:TOP]
    main = spans._Threads(
        e for e in events if e.get("cat") == "user_annotation"
        and e.get("name") in set(names) and "dur" in e)
    chains = main.chains([(spans._thread(win), 0.5 * (a + b))
                          for _, a, b in gaps])
    idle = [{"ms": length * 1e-3, "at_ms": (a - w0) * 1e-3,
             "spans": "/".join(r["name"] for r in chain) or "none"}
            for (length, a, _), chain in zip(gaps, chains)]
    return {"steps": steps, "spans_per_step": opened / steps,
            "device_ms_per_step": sum(r["forward_ms"] + r["backward_ms"]
                                      for r in rows.values()),
            "by_owner": dict(sorted(rows.items(), key=lambda kv: -(
                kv[1]["forward_ms"] + kv[1]["backward_ms"]))),
            "by_metric": {m: sum(r["forward_ms"] + r["backward_ms"]
                                 for p, r in rows.items()
                                 if spans.subtree(p) == m)
                          for m in [n for n, _ in spans.SUBTREES]
                          + [spans.UNATTRIBUTED]},
            "idle_gaps": idle}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    run._environment()
    from perfbench.lib import harness, spans, trace
    got = {}
    reduce_events = trace.reduce_events

    def keep(events, steps, *rest, **kw):
        got["events"], got["steps"] = events, steps
        return reduce_events(events, steps, *rest, **kw)

    trace.reduce_events = keep
    try:
        harness.run(ROOT, args.workload, args.seed, args.seconds, True,
                    time.perf_counter())
    finally:
        trace.reduce_events = reduce_events
    names = spans.step_spans()
    if names is None:
        harness.log("the program has no step spans")
        return 2
    out = report(got["events"], got["steps"], names)
    out["card"] = harness.card_line()
    for path, r in out["by_owner"].items():
        print(f"{r['forward_ms']:9.3f} {r['backward_ms']:9.3f}  {path}")
        for name, ms in r["top"]:
            print(f"{'':21}{ms:9.3f}  {name}")
    print(json.dumps({k: v for k, v in out.items() if k != "by_owner"},
                     indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
