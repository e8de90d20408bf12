"""Device time by program span: every kernel, copy and fill of the traced
window is put down to one owner, a path of the program's step spans
(``apex_tpu_torch.telemetry.trace.STEP_SPANS``, outermost first, joined by
``/``) or ``unattributed``.

The owner of a device operation is found through its launch (the runtime
call of the same ``correlation``), from the ranges open around that
launch on its own thread: the step spans (``user_annotation`` rows) and
the backward's ``autograd::engine::evaluate_function`` rows.

- Where the innermost of them is a step span, the owner is the path of
  the step spans inside the innermost backward row (all of them where
  there is none): the forward, amp's update, a recompute under remat.
- Where it is a backward row, the owner is the path around the forward
  op that made the row's node: the latest op outside any backward row
  with the row's ``Sequence number``, before the row.  (The export gives a
  forward op no id of its own thread, so the number alone links them; it
  is unique on a thread.)  Where no forward op carries the number, the
  step spans around the row own it (``train.backward`` where the
  backward runs on the caller's thread).
- Else, and where no launch is found: ``unattributed``.

:func:`install` adds ``span_s`` (device seconds by owner) to what
``perfbench.lib.trace.reduce_events`` returns, every other key computed
as before; the readers of the span metrics install it when they are
loaded.  A program without ``STEP_SPANS`` gets no ``span_s``, and the
readers then return None.

The span metrics (device ms a step of a subtree, forward and backward):
``embed_ms.bert`` ``model.embed``; ``attention_ms.bert``
``model.attention``; ``mlp_ms.bert`` ``model.mlp``;
``head_loss_ms.bert`` ``model.head`` and ``model.loss``;
``amp_update_ms.bert`` ``amp.step``; ``unattributed_ms.bert`` the rest,
the ``train.*`` glue included.  The six sum to the window's device ms a
step."""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench.lib import trace

UNATTRIBUTED = "unattributed"
BACKWARD_ROW = "autograd::engine::evaluate_function:"
#: the metrics' subtrees, in the order a path is tested against them
SUBTREES = (("embed", ("model.embed",)),
            ("attention", ("model.attention",)),
            ("mlp", ("model.mlp",)),
            ("head_loss", ("model.head", "model.loss")),
            ("amp_update", ("amp.step",)))


def step_spans() -> Optional[Tuple[str, ...]]:
    """The program's step span names, or None where it has none."""
    try:
        from apex_tpu_torch.telemetry.trace import STEP_SPANS
    except ImportError:
        return None
    return tuple(STEP_SPANS)


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _thread(e: dict) -> tuple:
    return (e.get("pid"), e.get("tid"))


class _Threads:
    """The ranges open at given points of each thread: answers
    :meth:`chains` for many points in one sweep a thread."""

    def __init__(self, ranges: Iterable[dict]):
        self.by_thread: Dict[tuple, List[dict]] = {}
        for r in ranges:
            self.by_thread.setdefault(_thread(r), []).append(r)
        for rs in self.by_thread.values():
            rs.sort(key=lambda r: (float(r["ts"]), -float(r["dur"])))

    def chains(self, points: Sequence[Tuple[tuple, float]]) -> List[tuple]:
        """For each (thread, time): the ranges open there, outermost
        first."""
        out: List[tuple] = [()] * len(points)
        by_thread: Dict[tuple, List[int]] = {}
        for i, (th, _) in enumerate(points):
            by_thread.setdefault(th, []).append(i)
        for th, idx in by_thread.items():
            rs, j, stack = self.by_thread.get(th, []), 0, []
            for i in sorted(idx, key=lambda i: points[i][1]):
                t = points[i][1]
                while j < len(rs) and float(rs[j]["ts"]) <= t:
                    r = rs[j]
                    while stack and _end(stack[-1]) <= float(r["ts"]):
                        stack.pop()
                    stack.append(r)
                    j += 1
                while stack and _end(stack[-1]) <= t:
                    stack.pop()
                out[i] = tuple(stack)
        return out


def _is_backward(r: dict) -> bool:
    return r.get("cat") == "cpu_op" and r["name"].startswith(BACKWARD_ROW)


def _spans_after_backward(chain: tuple) -> List[str]:
    """The step spans inside the innermost backward row of ``chain`` (all
    of them where it has none)."""
    names: List[str] = []
    for r in chain:
        if _is_backward(r):
            names = []
        else:
            names.append(r["name"])
    return names


def _path(names: List[str]) -> str:
    return "/".join(names) if names else UNATTRIBUTED


def attribute(events: List[dict], names: Sequence[str]
              ) -> List[Tuple[dict, str, bool]]:
    """Every device operation of the window with its owner's path and
    whether the backward rule found it: ``(event, path, backward)``."""
    names = set(names)
    wins = [e for e in events if e.get("name") == trace.WINDOW
            and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} window ranges")
    w0, w1 = float(wins[0]["ts"]), _end(wins[0])
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS
              and w0 <= float(e["ts"]) < w1]
    launches = {}
    for e in events:
        if e.get("cat") in trace.LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = e
    ranges = [e for e in events if e.get("ph", "X") == "X" and "dur" in e
              and ((e.get("cat") == "user_annotation"
                    and e.get("name") in names) or _is_backward(e))]
    threads = _Threads(ranges)
    fwd_ops = [e for e in events if e.get("cat") == "cpu_op"
               and "Sequence number" in e.get("args", {})
               and not e["name"].startswith(BACKWARD_ROW)]

    launch_of = [launches.get(e.get("args", {}).get("correlation"))
                 for e in device]
    found = [(i, l) for i, l in enumerate(launch_of) if l is not None]
    chains = threads.chains([(_thread(l), float(l["ts"])) for _, l in found])
    fwd_chains = threads.chains([(_thread(e), float(e["ts"]))
                                 for e in fwd_ops])
    # forward ops by number: outside any backward row, in time order
    by_seq: Dict[int, List[Tuple[float, tuple]]] = {}
    for e, chain in zip(fwd_ops, fwd_chains):
        if not any(_is_backward(r) for r in chain):
            by_seq.setdefault(e["args"]["Sequence number"], []).append(
                (float(e["ts"]), chain))
    for v in by_seq.values():
        v.sort(key=lambda x: x[0])

    out = [(e, UNATTRIBUTED, False) for e in device]
    for (i, _), chain in zip(found, chains):
        if not chain:
            continue
        if not _is_backward(chain[-1]):
            out[i] = (device[i], _path(_spans_after_backward(chain)), False)
            continue
        row = chain[-1]
        cands = by_seq.get(row.get("args", {}).get("Sequence number"), [])
        k = bisect.bisect_left(cands, float(row["ts"]),
                               key=lambda x: x[0]) - 1
        if k >= 0:
            path = _path(_spans_after_backward(cands[k][1]))
        else:
            path = _path([r["name"] for r in chain if not _is_backward(r)])
        out[i] = (device[i], path, True)
    return out


def span_seconds(events: List[dict], names: Sequence[str]
                 ) -> Dict[str, float]:
    """Device seconds of the window by owner (:func:`attribute`)."""
    out: Dict[str, float] = {}
    for e, path, _ in attribute(events, names):
        out[path] = out.get(path, 0.0) + float(e["dur"]) * 1e-6
    return out


def subtree(path: str) -> str:
    """The metric subtree a path belongs to (:data:`SUBTREES`), else
    :data:`UNATTRIBUTED`."""
    parts = path.split("/")
    for name, roots in SUBTREES:
        if any(r in parts for r in roots):
            return name
    return UNATTRIBUTED


def ms_per_step(rec: dict, name: str) -> Optional[float]:
    """Device ms a step of the subtree ``name`` (or of
    :data:`UNATTRIBUTED`); None where the run holds no ``span_s``."""
    t = rec.get("trace")
    if not t or not t.get("steps") or t.get("span_s") is None:
        return None
    s = sum(v for p, v in t["span_s"].items() if subtree(p) == name)
    return 1e3 * s / t["steps"]


def install() -> None:
    """Make ``trace.reduce_events`` also return ``span_s`` (once)."""
    plain = trace.reduce_events
    if getattr(plain, "plain", None) is not None:
        return

    def reduce_events(events, *args, **kwargs):
        out = plain(events, *args, **kwargs)
        names = step_spans()
        if names is not None:
            out["span_s"] = span_seconds(events, names)
        return out

    reduce_events.plain = plain
    reduce_events.__doc__ = plain.__doc__
    trace.reduce_events = reduce_events


install()
