"""Deterministic, seeded fault injection.

Counterpart of ``apex_tpu/resilience/faults.py``.  A :class:`FaultPlan` is
a parsed list of :class:`FaultSpec` entries, each "fire fault KIND at step
STEP (for COUNT consecutive steps, with ARG)".  Every firing is consumed as
it fires, so a replay of the faulted steps runs clean.

Spec grammar (config string or the ``APEX_TPU_FAULTS`` environment
variable, the JAX package's name, so one spec drives both)::

    APEX_TPU_FAULTS="nan@5x3;preempt@40;loader_stall@10:1.5;seed=7"

    entry      := KIND@STEP [ xCOUNT ] [ :ARG ] | seed=N
    KIND       := nan | inf | preempt | loader_stall | collective_fail
                  | oom | resize | shard_corrupt | index_missing
                  | request_flood | straggler | goodput_degrade
                  (aliases: nan_grads -> nan, inf_grads -> inf,
                   sigterm -> preempt)
    STEP       := first step (0-based) the fault is armed at
                  (index_missing: the dataset-OPEN call index, like
                  collective_fail counts wrapper calls)
    COUNT      := consecutive steps it stays armed (default 1)
    ARG        := kind-specific float (loader_stall: seconds to stall;
                  resize: REQUIRED target world size, e.g. resize@40:4;
                  request_flood: REQUIRED burst size K;
                  straggler: REQUIRED slowdown factor F > 1;
                  goodput_degrade: REQUIRED badput seconds per armed
                  step F > 0;
                  shard_corrupt: byte offset to flip, default mid-file)

Consumers in this package:

  * ``loader_stall`` — :func:`maybe_stall` (called inside the timed wait
    of ``data.sharded.ShardedLoader``'s iteration) and
    :class:`StallingIterator` sleep ``ARG`` seconds before the scheduled
    batch, tripping the loader's ``wait_timeout`` detection;
  * ``shard_corrupt`` — ``data.sharded.ShardedLoader`` flips one byte (ARG
    = byte offset; default mid-file) in the in-memory copy of the shard
    the scheduled step reads, so its CRC32 check fails with the typed
    ``ShardChecksumError``; the file on disk is never touched;
  * ``index_missing`` — ``data.sharded.load_index`` behaves as if
    ``INDEX.json`` were gone on the scheduled open call and degrades to a
    directory scan with ``IndexMissingWarning``;
  * ``collective_fail`` — :func:`wrap_collective` raises
    :class:`CollectiveFault` on the scheduled call index;
  * ``nan`` / ``inf`` — :func:`corrupt` poisons a batch's or gradient
    tree's floating leaves.

The other kinds parse here as in the JAX package; their consumers (the
training guard's preemption, OOM, resize, straggler and goodput
injections, the serving scheduler's request flood) come with the modules
that hold them.

The module imports nothing of the package at import time, so the data
plane can probe for an active plan at near-zero cost.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import List, Optional, Tuple

KINDS = ("nan", "inf", "preempt", "loader_stall", "collective_fail", "oom",
         "resize", "shard_corrupt", "index_missing", "request_flood",
         "straggler", "goodput_degrade")
_ALIASES = {"nan_grads": "nan", "inf_grads": "inf", "sigterm": "preempt"}

_ENTRY = re.compile(r"^(?P<kind>[a-z_]+)@(?P<step>\d+)"
                    r"(?:x(?P<count>\d+))?(?::(?P<arg>[0-9.]+))?$")


class FaultError(ValueError):
    """A fault spec string does not parse."""


class CollectiveFault(RuntimeError):
    """Injected collective failure (raised by :func:`wrap_collective`)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` armed for steps
    [``step``, ``step + count``), with a kind-specific ``arg``."""
    kind: str
    step: int
    count: int = 1
    arg: float = 0.0


class FaultPlan:
    """A parsed fault schedule with one-shot consumption state.

    :meth:`fire` is the single gate every consumer calls: it returns the
    matching :class:`FaultSpec` (consuming one armed firing) when
    ``kind`` has a fault scheduled at ``step``, else None.  Once a
    spec's ``count`` firings are consumed it never fires again — a
    rollback replay of the same steps runs clean.
    """

    def __init__(self, specs, seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self._fired = [0] * len(self.specs)

    def __repr__(self):
        return f"FaultPlan({list(self.specs)!r}, seed={self.seed})"

    @property
    def empty(self) -> bool:
        return not self.specs

    def reset(self) -> None:
        """Re-arm every spec (a fresh run over the same plan)."""
        self._fired = [0] * len(self.specs)
        # the collectives chaos gate keys its per-entry-point call
        # indices on the plan — a re-armed plan starts counting fresh
        self.__dict__.pop("_scheme_calls", None)

    def fire(self, kind: str, step: int) -> Optional[FaultSpec]:
        """Consume and return the armed spec of ``kind`` scheduled at
        ``step`` (or earlier, if the consumer skipped past it), if any."""
        for i, s in enumerate(self.specs):
            if s.kind != kind or self._fired[i] >= s.count:
                continue
            if step >= s.step + self._fired[i]:
                self._fired[i] += 1
                return s
        return None

    def skip_until(self, step: int) -> None:
        """Consume every firing that already happened in a run
        interrupted at ``step`` — called by the guard after a resume so
        a plan re-armed from the env in a fresh process doesn't re-fire
        them (a re-firing preempt would wedge the run in a
        preempt/resume loop).  ``preempt`` and ``resize`` fire BEFORE
        their step runs, so one at exactly ``step`` is elapsed; every
        other kind fires with its step, so a firing scheduled AT the
        resume step never ran and stays armed — the resumed run is the
        faithful continuation of the schedule."""
        for i, s in enumerate(self.specs):
            horizon = step - s.step + (1 if s.kind in ("preempt", "resize")
                                       else 0)
            if horizon > 0:
                self._fired[i] = max(self._fired[i],
                                     min(s.count, horizon))

    def pending(self, kind: Optional[str] = None) -> List[FaultSpec]:
        """Specs with firings remaining (optionally filtered by kind)."""
        return [s for i, s in enumerate(self.specs)
                if self._fired[i] < s.count
                and (kind is None or s.kind == kind)]


def parse(spec: str) -> FaultPlan:
    """Parse the fault-spec grammar (see module docstring)."""
    specs: List[FaultSpec] = []
    seed = 0
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            try:
                seed = int(entry[5:])
            except ValueError:
                raise FaultError(f"bad seed entry {entry!r}") from None
            continue
        m = _ENTRY.match(entry)
        if not m:
            raise FaultError(
                f"bad fault entry {entry!r}; expected KIND@STEP[xCOUNT]"
                f"[:ARG] with KIND in {KINDS} (or an alias "
                f"{tuple(_ALIASES)})")
        kind = _ALIASES.get(m.group("kind"), m.group("kind"))
        if kind not in KINDS:
            raise FaultError(f"unknown fault kind {m.group('kind')!r}; "
                             f"valid: {KINDS} + aliases {tuple(_ALIASES)}")
        arg = float(m.group("arg") or 0.0)
        if kind == "resize" and (arg < 1 or arg != int(arg)):
            raise FaultError(
                f"resize needs a positive integer target world size: "
                f"resize@STEP:M (got {entry!r})")
        if kind == "request_flood" and (arg < 1 or arg != int(arg)):
            raise FaultError(
                f"request_flood needs a positive integer burst size: "
                f"request_flood@STEP:K (got {entry!r})")
        if kind == "straggler" and arg <= 1:
            raise FaultError(
                f"straggler needs a slowdown factor > 1: "
                f"straggler@STEP:F (got {entry!r})")
        if kind == "goodput_degrade" and arg <= 0:
            raise FaultError(
                f"goodput_degrade needs badput seconds > 0: "
                f"goodput_degrade@STEP:F (got {entry!r})")
        specs.append(FaultSpec(
            kind=kind, step=int(m.group("step")),
            count=int(m.group("count") or 1), arg=arg))
    return FaultPlan(specs, seed=seed)


# ---------------------------------------------------------------------------
# process-default plan (config install > APEX_TPU_FAULTS env)
# ---------------------------------------------------------------------------

_installed: Optional[FaultPlan] = None
_env_cache: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-default (None uninstalls).
    Returns the previous installed plan so tests can restore it."""
    global _installed
    prev = _installed
    _installed = plan
    return prev


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed (once) from
    ``APEX_TPU_FAULTS``; None when no faults are configured.  The env
    plan is cached per env value, so its one-shot consumption state
    persists across calls — a fault fired from the env spec stays
    consumed for the process lifetime."""
    global _env_cache
    if _installed is not None:
        return _installed
    env = os.environ.get("APEX_TPU_FAULTS")
    if not env:
        return None
    if _env_cache[0] != env:
        _env_cache = (env, parse(env))
    return _env_cache[1]


# ---------------------------------------------------------------------------
# consumers' helpers
# ---------------------------------------------------------------------------

def corrupt(tree, kind: str = "nan"):
    """Poison every floating leaf of ``tree`` (tensors and numpy arrays)
    with NaN (or Inf); integer and bool leaves and non-arrays pass
    through."""
    import numpy as np
    import torch

    from ..utils.pytree import tree_map
    val = float("nan") if kind == "nan" else float("inf")

    def poison(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return torch.full_like(x, val)
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            return np.full_like(x, val)
        return x
    return tree_map(poison, tree)


def maybe_stall(step: int, *, plan: Optional[FaultPlan] = None) -> float:
    """Sleep (and return the stall seconds) when a ``loader_stall``
    fault is scheduled at ``step``; 0.0 otherwise.  The data loader
    calls this inside its timed wait so the injected stall is exactly
    what its ``wait_timeout`` detection sees."""
    p = plan if plan is not None else active_plan()
    if p is None:
        return 0.0
    spec = p.fire("loader_stall", step)
    if spec is None:
        return 0.0
    if spec.arg > 0:
        time.sleep(spec.arg)
    return spec.arg


class StallingIterator:
    """Wrap any batch iterator with scheduled ``loader_stall`` faults —
    the shim for loaders without the hook built in."""

    def __init__(self, inner, plan: Optional[FaultPlan] = None):
        self._inner = inner
        self._plan = plan
        self._step = 0

    def __iter__(self):
        for item in self._inner:
            maybe_stall(self._step, plan=self._plan)
            self._step += 1
            yield item


#: nominal per-step base the injected straggler slowdown scales from —
#: small enough that a chaos run with dozens of armed steps stays in
#: tier-1's budget, large enough to dominate host timing noise
STRAGGLER_BASE_S = 0.002
#: hard cap on any single injected straggler delay (a wild F in a spec
#: must not turn a chaos test into a hang)
STRAGGLER_CAP_S = 0.05


def straggler_delay(arg: float, *, base_s: float = STRAGGLER_BASE_S,
                    cap_s: float = STRAGGLER_CAP_S) -> float:
    """Seconds of extra in-step delay a ``straggler@N:F`` injection
    adds: ``base * (F - 1)``, capped.  The guard sleeps this inside the
    ``train.step`` span (the slowdown is real step time, not badput)
    and reports the factor ``F`` itself in the per-device busy rows —
    the delay makes the wall-clock honest, the rows make the
    leave-one-out z-score deterministic."""
    return min(cap_s, base_s * max(0.0, float(arg) - 1.0))


def wrap_collective(fn, *, plan: Optional[FaultPlan] = None,
                    name: Optional[str] = None):
    """Return ``fn`` wrapped to raise :class:`CollectiveFault` when a
    ``collective_fail`` fault is scheduled at the wrapper's call index
    (one index per call: the port runs eagerly)."""
    import functools
    label = name or getattr(fn, "__name__", "collective")
    calls = {"n": 0}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        i = calls["n"]
        calls["n"] += 1
        p = plan if plan is not None else active_plan()
        if p is not None and p.fire("collective_fail", i) is not None:
            raise CollectiveFault(
                f"injected collective failure in {label} (call {i})")
        return fn(*args, **kwargs)
    return wrapped
