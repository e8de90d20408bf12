"""``TrainGuard``: a self-resuming runner around any step function.

Counterpart of ``apex_tpu/resilience/guard.py``, with its names and
semantics.  The guard owns the step loop and gives it

  * **checkpoint cadence**: every ``save_every_steps`` steps and/or
    ``save_every_seconds`` of wall clock, snapshots are taken at
    health-checked boundaries and written by a background thread (the
    step loop never waits on the disk);
  * **preemption safety**: SIGTERM / SIGINT (real, or injected through a
    ``preempt`` fault) become snapshot-then-clean-exit, and the previous
    handlers come back when the run ends;
  * **auto-resume**: a new ``run()`` over the same checkpoint directory
    starts at the manifest's newest verified checkpoint (corrupt files
    are skipped), bit for bit when the batch source is step-addressable;
  * **escalation -> rollback**: a non-finite-loss streak or a dynamic loss
    scale pinned at its floor (``amp.scaler.floor_pinned``) rolls the
    state back to the last good checkpoint, with a bounded retry budget
    and exponential backoff;
  * **telemetry**: ``fault_injected`` / ``rollback`` / ``resumed`` /
    ``preempted`` events through the registry (the installed default, or
    one passed in), the run's goodput ledger finalised into
    ``GOODPUT.json``, flight dumps on rollback, preemption and crash, and
    the OOM post-mortem (which re-raises and burns no retry).

Step-fn contract: ``step_fn(state, batch) -> new_state`` or ``(new_state,
loss, *aux)``; ``state`` is a tree of tensors: an ``AmpState``, a tuple
carry such as ``(amp_state, bn_state)``, a dict.  Its leaves are the
tensors of dicts (keys sorted), lists, tuples, named tuples and
dataclasses (fields in order), and ``torch.Generator``s, whose states
are saved and set back in place (a step that draws dropout from a
generator carried in the state then resumes bit for bit); anything else
(Python numbers, optimizer objects) is static and stays the live
state's.  The batch source is a callable ``batches(step) -> batch``
(step-addressable: resume and rollback replay the same data) or a plain
iterator (resume continues it; a needed rollback aborts with
:class:`GuardAbort`).

Host reads: the pending losses and the loss scale are stacked on the
device and read with ONE ``.cpu()`` a ``check_every`` steps; a snapshot
is one more batched read (every device leaf concatenated as bytes, one
copy).  :attr:`TrainGuard.host_reads` counts them, so that a run's reads
equal its health checks (:attr:`TrainGuard.health_checks`) plus its
snapshots (``GuardReport.checkpoints``).  A disabled guard
(``GuardConfig(enabled=False)`` or ``APEX_TPU_GUARD=0``) calls the step
function and nothing else: no read, no thread, no signal handler, no
checkpoint directory.

Snapshots under a process group (``state_shards=``): a zero1 rank holds
only its 1/N slice of the flat master and moments, and its own int8
error-feedback residual.  ``state_shards`` names those leaves (a prefix
tree of the state: ``"shard"`` for a 1/N slice of a canonical flat
field, ``"stack"`` for a per-rank full-flat buffer, anything else
replicated; ``train.flagship_guard_step`` returns it) over the data group
``shard_group=`` (the weight update's group; default the default process
group).  At world N > 1 (N the data group's size) a snapshot all-gathers
them over that group before its one host read: each shard field becomes
the canonical flat of length ``layout["flat_total"]`` and the stack
leaves become ``(N, flat_total)``, the JAX package's payload.  A
``layout`` in ``ckpt_meta`` is held against the shard fields at the run's
start (``ValueError`` when a shard times N is not its ``flat_total``, as
when the group is not the one the layout was built for).  The gathers are
counted beside the reads, in :attr:`TrainGuard.gathers`: at most two a
snapshot (every shard leaf's bytes in one, every stack leaf's in the
other), none at world 1, where the snapshot is the plain one, byte for
byte.  Rank 0 of the data group writes the checkpoint (under other mesh
axes each data group holds its own state, so give each its own
``ckpt_dir``); every rank takes the same checks, snapshots and exits (the
step's loss is the group's mean, and a fault plan fires at the same step
everywhere), so ``host_reads == health_checks + checkpoints`` on every
rank.  At restore each rank takes its slice of the canonical payload,
through the resharder when the saved world differs.  A run returns on no
rank before its group's checkpoints are on disk, and a rollback reads
only after them (barriers over the data group).  A
``save_every_seconds`` cadence, which each rank's clock would decide on
its own, is refused at world > 1.

The run controller (``controller=``, :mod:`apex_tpu_torch.control`) rides
the health check: after the window's one read the guard feeds it per-rank
busy rows from host step timing and calls ``on_window`` with the losses
that read resolved; it makes no read of its own.  Under a process group
of more than one rank each rank's controller decides on global rank 0's
signals: once a window they are broadcast over a gloo group (the default
group when it is gloo, else one the guard makes once), a host
collective counted in :attr:`TrainGuard.control_syncs`, so that every
rank takes the same decisions and the same actions (a wire scheme that
changed on one rank alone would mismatch the collectives).  A disabled
controller is dropped before the loop starts, so the run is the
controller-free one bit for bit, with the same reads.  Its
``CONTROL.json`` is written beside ``GOODPUT.json``, by global rank 0
alone under a process group.  A world-size mismatch at resume raises
``WorldSizeMismatchError`` unless a resharder is installed
(:func:`set_resharder`, ``apex_tpu_torch.elastic.install``, or
``elastic=``).

Whatever way a run ends (completed, preempted, ``GuardAbort``, an OOM or
any other exception) the guard leaves the process as it found it: the
signal handlers, the installed goodput ledger and the tracer's ledger
hook, the installed fault plan (the plan's one-shot firings stay
consumed, as the JAX package's do), and no writer thread left running.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import signal
import threading
import time
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from . import faults as _faults
from .ckpt import (CheckpointManager, DataStreamMismatchError,
                   ManifestCompatWarning, WorldSizeMismatchError,
                   META_DATA_KEY, META_LAYOUT_KEY, META_WORLD_KEY)
from .. import _pickle_compat
from ..checkpoint import CheckpointError, _host_tensor
from ..telemetry import events as _tel_events
from ..telemetry import export as _export
from ..telemetry import goodput as _goodput
from ..telemetry import memory as _tmem
from ..telemetry import trace as _trace

__all__ = ["TrainGuard", "GuardConfig", "GuardReport", "GuardAbort",
           "set_resharder", "get_resharder"]


class GuardAbort(RuntimeError):
    """The guard cannot make progress: rollback budget exhausted, no
    checkpoint to roll back to, or a rollback was needed on a
    non-replayable (iterator) batch source."""


def _env_enabled() -> bool:
    return _trace.env_flag("APEX_TPU_GUARD")


# -- the resharder hook ------------------------------------------------------
# Anything with a ``resume(template, payload, saved_meta, live_world,
# emit=...) -> payload`` method qualifies.  Without one, a world-size
# mismatch at resume is a typed failure (WorldSizeMismatchError), never a
# silent restore of mis-sliced shards.

_RESHARDER = None


def set_resharder(resharder):
    """Install ``resharder`` as the process default (None uninstalls).
    Returns the previous one so callers can restore it."""
    global _RESHARDER
    prev = _RESHARDER
    _RESHARDER = resharder
    return prev


def get_resharder():
    return _RESHARDER


@dataclasses.dataclass
class GuardConfig:
    """Policy knobs for :class:`TrainGuard`.

    ``check_every`` is the health-check cadence (steps per batched host
    read); checkpoint cadence is evaluated at those same boundaries, so
    every checkpoint is health-screened before it is written.
    ``floor_patience`` counts consecutive *checks* the dynamic loss scale
    sits at its floor before escalating; 0 disables that detector.
    ``flight_dir`` is where flight dumps land (default: the tracer's own
    directory, else next to the checkpoints).  ``enabled=None`` reads
    ``APEX_TPU_GUARD`` (default on).  ``world_size`` pins the live world
    recorded in the manifest; ``ckpt_meta`` is extra manifest meta merged
    in."""
    ckpt_dir: Optional[str] = None
    save_every_steps: int = 0
    save_every_seconds: float = 0.0
    keep_last: int = 3
    check_every: int = 10
    nonfinite_streak: int = 3
    floor_patience: int = 0
    max_retries: int = 3
    backoff_seconds: float = 0.25
    save_on_exit: bool = True
    auto_resume: bool = True
    flight_dir: Optional[str] = None
    enabled: Optional[bool] = None
    world_size: Optional[int] = None
    ckpt_meta: Optional[dict] = None

    def __post_init__(self):
        if self.enabled is None:
            self.enabled = _env_enabled()
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")


@dataclasses.dataclass
class GuardReport:
    """What a :meth:`TrainGuard.run` did.  ``status`` is ``"completed"``
    (reached num_steps), ``"preempted"`` (SIGTERM / SIGINT / an injected
    preemption: state snapshotted, a rerun resumes), or ``"disabled"``.
    The fields are the JAX package's."""
    status: str
    final_step: int
    resumed_from: Optional[int] = None
    rollbacks: int = 0
    faults_injected: int = 0
    checkpoints: int = 0
    #: an injected ``resize@N:M`` fault stopped the run: the world size
    #: to bring it back up at
    resize_to: Optional[int] = None
    #: the resume crossed a world-size change through a resharder
    resharded_from: Optional[int] = None
    #: the run's goodput ledger doc and the ``GOODPUT.json`` path it was
    #: written to (None when no tracer was active)
    goodput: Optional[dict] = None
    goodput_path: Optional[str] = None
    #: the run controller's decision-ledger doc and the ``CONTROL.json``
    #: path it was written to (None when no enabled controller rode the
    #: run)
    control: Optional[dict] = None
    control_path: Optional[str] = None
    #: the live OpenMetrics scrape URL this run served (None unless
    #: ``APEX_TPU_METRICS_PORT`` armed it)
    export_url: Optional[str] = None


def _observed_save(manager: CheckpointManager, step: int, payload,
                   registry=None) -> str:
    """``manager.save`` inside a ``ckpt.write`` span, with the write's
    duration and bytes as gauges through ``registry`` (or the process
    default).  Runs on whichever thread saves, the writer included."""
    t0 = time.perf_counter()
    with _trace.span("ckpt.write", step=step):
        path = manager.save(step, payload)
    dur = time.perf_counter() - t0
    try:
        nbytes = os.path.getsize(path)
    except OSError:   # pragma: no cover - raced rotation
        nbytes = 0
    _tel_events.record_ckpt(dur, nbytes, reg=registry)
    return path


class _AsyncWriter:
    """Background checkpoint writer: the loop hands (step, host payload)
    over a small bounded queue and keeps stepping while the pickle and the
    write happen on this thread.  A write failure is re-raised at the next
    submit / drain: a lost checkpoint would void the resume guarantee."""

    def __init__(self, manager: CheckpointManager, registry=None):
        self._manager = manager
        self._registry = registry
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="apex-tpu-torch-ckpt-writer")
        self._thread.start()
        self.written = 0

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, payload = item
                try:
                    _observed_save(self._manager, step, payload,
                                   registry=self._registry)
                    self.written += 1
                except BaseException as e:
                    self._exc = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, step: int, payload) -> None:
        self._check()
        self._q.put((step, payload))

    def drain(self) -> None:
        """Block until every submitted checkpoint is on disk."""
        self._q.join()
        self._check()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=60.0)


class _NullWriter:
    """The writer of a rank that writes no checkpoint (every rank of a
    process group but rank 0): the hand-offs are dropped."""
    written = 0

    def submit(self, step: int, payload) -> None:
        pass

    def drain(self) -> None:
        pass

    def close(self) -> None:
        pass


def _find_scaler(state):
    """The ``ScalerState`` the floor detector reads: ``state.scalers[0]``
    of an ``AmpState``, or of any element one level into a tuple / list /
    dict carry.  An explicit ``scaler_fn`` overrides this probe."""
    sc = getattr(state, "scalers", None)
    if sc:
        return sc[0]
    children = (state if isinstance(state, (tuple, list))
                else state.values() if isinstance(state, dict) else ())
    for el in children:
        sc = getattr(el, "scalers", None)
        if sc:
            return sc[0]
    return None


# -- the state's leaves ------------------------------------------------------

def _children(tree):
    """The sub-trees of a container, in leaf order, or None for a leaf or
    a static value."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return None


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, torch.Generator))


def _leaves(tree) -> List[Any]:
    if _is_leaf(tree):
        return [tree]
    kids = _children(tree)
    return [] if kids is None else [x for k in kids for x in _leaves(k)]


def _structure(tree):
    """A comparable description of ``tree``'s containers and leaves."""
    if _is_leaf(tree):
        return "leaf"
    kids = _children(tree)
    if kids is None:
        return None
    keys = tuple(sorted(tree)) if isinstance(tree, dict) else None
    return (type(tree), keys, tuple(_structure(k) for k in kids))


def _rebuild(template, it):
    """``template`` with its leaves replaced, in order, by ``it``'s."""
    if _is_leaf(template):
        return next(it)
    kids = _children(template)
    if kids is None or not _leaves(template):
        return template
    new = [_rebuild(k, it) for k in kids]
    if isinstance(template, dict):
        return type(template)(zip(sorted(template), new))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*new)
    if isinstance(template, (list, tuple)):
        return type(template)(new)
    return dataclasses.replace(template, **{
        f.name: v for f, v in zip(dataclasses.fields(template), new)})


#: ``state_shards`` leaf kinds: a 1/N slice of a canonical flat field, and
#: a per-rank full-flat buffer (the int8 error-feedback residual)
SHARD, STACK = "shard", "stack"


def _leaf_kinds(tree, spec) -> list:
    """The ``state_shards`` kind of each of ``tree``'s leaves, in leaf
    order: ``spec`` is a prefix tree of ``tree`` whose leaves are kinds
    (a kind, or None, covers every leaf under it)."""
    if spec is None or isinstance(spec, str):
        return [spec] * len(_leaves(tree))
    kids, skids = _children(tree), _children(spec)
    if kids is None or skids is None or len(kids) != len(skids) or (
            isinstance(tree, dict) and sorted(tree) != sorted(spec)):
        raise ValueError(
            f"state_shards does not match the state's structure at a "
            f"{type(tree).__name__} (spec: {type(spec).__name__})")
    return [k for t, sp in zip(kids, skids) for k in _leaf_kinds(t, sp)]


def _gather_bytes(tensors, group) -> List[torch.Tensor]:
    """Each rank's ``tensors``, all-gathered over ``group`` in ONE
    collective of their bytes: for each tensor, ``(world, *shape)``."""
    from ..parallel.collectives import _gather
    parts = [t.detach().reshape(-1).view(torch.uint8) for t in tensors]
    full = _gather(torch.cat(parts), group)
    world = full.numel() // sum(p.numel() for p in parts)
    rows = full.view(world, -1)
    out, off = [], 0
    for t, p in zip(tensors, parts):
        n = p.numel()
        out.append(rows[:, off:off + n].contiguous().view(t.dtype)
                   .view((world,) + tuple(t.shape)))
        off += n
    return out


def _numpy_dtype(dt: torch.dtype):
    return torch.empty((), dtype=dt).numpy().dtype


def _host_leaves(leaves) -> list:
    """The leaves as host values with one copy a device: every tensor of a
    device concatenated as bytes there and read in one ``.cpu()``, then
    cut into numpy arrays (bf16 as the checkpoint format's stand-in);
    a generator as its state bytes (host memory, no device read)."""
    out: List[Any] = [None] * len(leaves)
    groups = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Generator):
            out[i] = x.get_state().numpy().copy()
        else:
            groups.setdefault(x.device, []).append(i)
    for idx in groups.values():
        parts = [leaves[i].detach().reshape(-1).view(torch.uint8)
                 for i in idx]
        flat = torch.cat(parts).cpu().numpy()
        off = 0
        for i, p in zip(idx, parts):
            t = leaves[i]
            raw = flat[off:off + p.numel()]
            off += p.numel()
            if t.dtype == torch.bfloat16:
                out[i] = _pickle_compat.bf16_to_numpy(
                    raw.view(np.int16).reshape(t.shape))
            else:
                out[i] = raw.view(_numpy_dtype(t.dtype)).reshape(t.shape)
    return out


class TrainGuard:
    """The step runner (the module docstring has the contract).

    ``plan`` pins a :class:`~apex_tpu_torch.resilience.faults.FaultPlan`
    (default: the installed / env plan at each ``run``); ``registry`` pins
    a telemetry registry (default: the process default at emit time);
    ``scaler_fn(state) -> ScalerState`` overrides the floor detector's
    probe; ``elastic`` pins a checkpoint resharder (default: the one
    :func:`set_resharder` installed); ``on_check(step, losses)`` gets the
    resolved loss window at every health check (host floats: printing
    them costs no read); ``controller`` pins an
    :class:`apex_tpu_torch.control.RunController` that rides the same
    window.  ``state_shards`` names the state's leaves that are sharded
    over ``shard_group`` (default: the default process group), as the
    module docstring sets out."""

    def __init__(self, step_fn: Callable, config: GuardConfig, *,
                 plan=None, registry=None, scaler_fn=None, elastic=None,
                 on_check: Optional[Callable[[int, List[float]],
                                             None]] = None,
                 controller=None, state_shards=None, shard_group=None):
        self.step_fn = step_fn
        self.cfg = config
        self._plan = plan
        self._registry = registry
        self._scaler_fn = scaler_fn
        self._elastic = elastic
        self._on_check = on_check
        self._controller = controller
        self._state_shards = state_shards
        self._group = shard_group
        self._sync_group = None     # the controller's gloo group (NCCL)
        self._report: Optional[GuardReport] = None
        self._stop = False
        #: batched device-to-host reads, and the health checks that made
        #: one, over this guard's runs
        self.host_reads = 0
        self.health_checks = 0
        #: collective gathers the snapshots made (world > 1 only)
        self.gathers = 0
        #: controller windows whose signals came from global rank 0
        #: (a process group of more than one rank only)
        self.control_syncs = 0
        self.manager = (CheckpointManager(config.ckpt_dir,
                                          keep_last=config.keep_last)
                        if config.enabled and config.ckpt_dir else None)

    # -- the process group -----------------------------------------------------
    def _shard_group(self):
        """``(group, world, rank)`` of a sharded state's snapshots (the
        data group): world 1 and rank 0 without ``state_shards`` or a
        process group."""
        import torch.distributed as dist
        if self._state_shards is None or not (dist.is_available()
                                              and dist.is_initialized()):
            return None, 1, 0
        group = self._group if self._group is not None else dist.group.WORLD
        return group, dist.get_world_size(group), dist.get_rank(group)

    def _check_layout(self, state, world: int) -> None:
        """Each shard field of ``state`` times the data group's ``world``
        must be the ``flat_total`` of the layout in ``ckpt_meta``."""
        layout = (self.cfg.ckpt_meta or {}).get(META_LAYOUT_KEY)
        if self._state_shards is None or not isinstance(layout, dict) \
                or "flat_total" not in layout:
            return
        for t, kind in zip(_leaves(state),
                           _leaf_kinds(state, self._state_shards)):
            if kind == SHARD and t.shape[0] * world != layout["flat_total"]:
                raise ValueError(
                    f"a shard field of {t.shape[0]} elements over a data "
                    f"group of {world} is not the layout's flat_total "
                    f"{layout['flat_total']}: pass the weight update's "
                    f"group as shard_group")

    def _control_sync(self):
        """``(sync, writes)`` for the controller: ``sync(payload)``
        returns global rank 0's payload on every rank (a gloo broadcast,
        counted in :attr:`control_syncs`), None without a process group
        of more than one rank; ``writes`` is whether this rank writes
        ``CONTROL.json``."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return None, True
        # host values only: a gloo group even when the default is NCCL
        # (made once a guard: every rank runs the same guards in order)
        if dist.get_backend() != "gloo" and self._sync_group is None:
            self._sync_group = dist.new_group(backend="gloo")
        group = self._sync_group

        def sync(payload):
            box = [payload]
            dist.broadcast_object_list(box, src=0, group=group)
            self.control_syncs += 1
            return box[0]
        return sync, dist.get_rank() == 0

    def _writes(self) -> bool:
        """Does this rank write the checkpoints (rank 0 of the group)?"""
        return self._shard_group()[2] == 0

    # -- telemetry ----------------------------------------------------------
    def _emit(self, name: str, **fields) -> None:
        reg = self._registry
        if reg is None:
            reg = _tel_events.get_default()
        if reg is not None and reg.enabled:
            reg.event(name, **fields)   # the registry copies the event
            return                      # into the flight ring itself
        _trace.note_event(name, step=fields.get("step"), fields=fields)

    def _flight_destination(self, recorder_directory):
        """The dump directory: ``cfg.flight_dir`` > the recorder's own >
        next to the checkpoints."""
        return (self.cfg.flight_dir or recorder_directory
                or (self.manager.directory if self.manager else None))

    def _dump_flight(self, reason: str, step: int, **fields):
        """Dump the flight recorder on a rollback, a preemption or an
        unhandled exception; best-effort (a failed dump never fails the
        run).  Returns the written path or None."""
        tr = _trace.get_tracer()
        if tr is None or not tr.enabled:
            return None
        directory = self._flight_destination(tr.recorder.directory)
        if directory is None:
            return None
        try:
            return tr.recorder.dump(reason, step=step, directory=directory,
                                    fields=fields)
        except Exception:   # a failed dump must never mask the real
            return None     # error propagating through run()

    def _dump_oom(self, step: int, exc: BaseException):
        """The OOM post-mortem (``flight-oom-<ts>.json``), written even
        when no tracer is installed; best-effort, and the OOM re-raises
        either way."""
        tr = _trace.get_tracer()
        recorder = tr.recorder if (tr is not None and tr.enabled) else None
        directory = self._flight_destination(
            recorder.directory if recorder is not None else None)
        if directory is None:
            return None
        reg = self._registry
        if reg is None:
            reg = _tel_events.get_default()
        try:
            return _tmem.dump_oom(recorder, step=step, error=exc,
                                  directory=directory, registry=reg)
        except Exception:
            return None

    def _blocked_ckpt(self, step: int, fn):
        """Run a checkpoint operation the step loop waits on (a writer
        drain / submit, an inline anchor or exit save) inside a
        ``ckpt.exposed`` span and meter: only this time charges the
        goodput ledger; the writer's own ``ckpt.write`` overlaps."""
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            dur = time.perf_counter() - t0
            _trace.note_span("ckpt.exposed", dur, step=step)
            _tel_events.record_ckpt_exposed(dur, reg=self._registry,
                                            step=step)

    def _finalize_control(self, ctl, tracer, report, writes: bool) -> None:
        """Close the controller's decision ledger (best-effort, as
        :meth:`_finalize_goodput`): the ``CONTROL.json`` doc with the
        run's final status, written on the flight destination chain by
        the writing rank."""
        try:
            doc = ctl.snapshot(status=report.status)
            report.control = doc
            directory = self._flight_destination(
                tracer.recorder.directory
                if tracer is not None and tracer.enabled else None)
            if directory is not None and writes:
                report.control_path = ctl.write(directory=directory,
                                                doc=doc)
        except Exception:   # the audit artifact must never mask the
            pass            # run's real outcome

    # -- controller actuation --------------------------------------------------
    def request_resize(self, target_world: int, *, step=None,
                       reason: str = "control") -> None:
        """A synthesized ``resize@N:M``: the controller's quarantine
        actuator calls this from inside the health-check boundary, so no
        signal is needed: the target world goes into the report, the stop
        flag is set, and the loop's preemption path snapshots and exits
        cleanly for the harness to bring the run back at
        ``target_world`` through the elastic reshard."""
        rep = self._report
        if rep is None:
            raise RuntimeError("request_resize outside an active "
                               "guarded run")
        rep.resize_to = int(target_world)
        self._emit("control.resize_requested", step=step,
                   target_world=int(target_world), reason=str(reason))
        self._stop = True

    def _finalize_goodput(self, ledger, tracer, prev_hook, prev_ledger,
                          report):
        """Close the run's goodput ledger (best-effort): detach it from the
        tracer (its previous ledger hook back), put the previously
        installed process ledger back, export the final gauges and write
        ``GOODPUT.json`` on the flight destination chain: exit, preempt
        and crash all leave the artifact."""
        ledger.detach(tracer)
        tracer.ledger = prev_hook
        _goodput.install(prev_ledger)
        try:
            doc = ledger.snapshot(status=report.status)
            report.goodput = doc
            reg = self._registry
            if reg is None:
                reg = _tel_events.get_default()
            ledger.observe(reg, doc=doc)
            directory = self._flight_destination(tracer.recorder.directory)
            if directory is not None:
                report.goodput_path = ledger.write(directory=directory,
                                                   doc=doc)
        except Exception:   # disk full / off-schema doc: the run's
            pass            # outcome must still propagate untouched

    # -- state <-> host ------------------------------------------------------
    def _save_now(self, mgr, step: int, state, writes: bool):
        """An inline save: the snapshot (a collective under a process
        group, so every rank takes it), written by the writing rank."""
        payload = self._snapshot(state, step)
        if writes:
            _observed_save(mgr, step, payload, registry=self._registry)

    def _snapshot(self, state, step: int) -> dict:
        """The host payload of ``state``: its leaf list, read in one
        batched copy, rebuilt at restore against the live state's
        structure (static values are never pickled).  At world > 1 the
        sharded leaves are first gathered into their canonical form."""
        leaves = _leaves(state)
        group, world, _ = self._shard_group()
        if world > 1:
            kinds = _leaf_kinds(state, self._state_shards)
            for kind in (SHARD, STACK):
                idx = [i for i, k in enumerate(kinds) if k == kind]
                if not idx:
                    continue
                full = _gather_bytes([leaves[i] for i in idx], group)
                self.gathers += 1
                for i, f in zip(idx, full):
                    leaves[i] = f.reshape(-1) if kind == SHARD else f
        self.host_reads += 1
        return {"step": int(step), "leaves": _host_leaves(leaves)}

    def _canonical_template(self, state, world: int) -> list:
        """The live state's leaves in the canonical (checkpoint) shapes
        at ``world``: a shard field (T / N,) as (T,), a stack leaf (T,) as
        (N, T); shapes only, on the meta device."""
        out = []
        kinds = _leaf_kinds(state, self._state_shards)
        for t, kind in zip(_leaves(state), kinds):
            if kind == SHARD:
                t = torch.empty((t.shape[0] * world,), dtype=t.dtype,
                                device="meta")
            elif kind == STACK:
                t = torch.empty((world,) + tuple(t.shape), dtype=t.dtype,
                                device="meta")
            out.append(t)
        return out

    def _local_payload(self, state, payload: dict) -> dict:
        """This rank's part of a canonical payload: its slice of each
        shard field and its row of each stack leaf (a world-1 snapshot's
        1-D stack leaf is its own row)."""
        if self._state_shards is None:
            return payload
        _, world, rank = self._shard_group()
        kinds = _leaf_kinds(state, self._state_shards)
        out = []
        for t, h, kind in zip(_leaves(state), payload["leaves"], kinds):
            if kind == SHARD and np.ndim(h) == 1 \
                    and np.shape(h)[0] == t.shape[0] * world:
                h = h[rank * t.shape[0]:(rank + 1) * t.shape[0]]
            elif kind == STACK and np.ndim(h) == 2:
                h = h[rank]
            out.append(h)
        return {**payload, "leaves": out}

    def _canonical_saved(self, state, payload: dict) -> dict:
        """A loaded payload with each 1-D stack leaf (a world-1
        snapshot's) given its leading world axis, so that the resharder
        sees the ``(saved_world, flat_total)`` stack the JAX package
        writes."""
        if self._state_shards is None:
            return payload
        kinds = _leaf_kinds(state, self._state_shards)
        if len(kinds) != len(payload["leaves"]):
            return payload          # _restore names the mismatch
        return {**payload, "leaves": [
            h[None] if kind == STACK and np.ndim(h) == 1 else h
            for h, kind in zip(payload["leaves"], kinds)]}

    @staticmethod
    def _restore(template, payload: dict):
        leaves = _leaves(template)
        saved = payload["leaves"]
        if len(saved) != len(leaves):
            raise CheckpointError(
                f"checkpoint has {len(saved)} leaves but the live state "
                f"has {len(leaves)}: the model / optimizer configuration "
                "changed since the checkpoint was written")

        def put(t, h):
            if isinstance(t, torch.Generator):
                t.set_state(torch.from_numpy(np.array(h, np.uint8)))
                return t
            src = _host_tensor(h)
            if tuple(src.shape) != tuple(t.shape):
                raise CheckpointError(
                    f"checkpoint leaf shape {tuple(src.shape)} != live "
                    f"{tuple(t.shape)}")
            # the template's device, dtype and strides (restore_like's
            # rule: a channels-last weight stays one)
            return torch.empty_like(t).copy_(src)
        return _rebuild(template, iter([put(t, h)
                                        for t, h in zip(leaves, saved)]))

    def _maybe_reshard(self, template, payload, saved_meta: dict,
                       live_world: Optional[int], report) -> dict:
        """A resume whose saved world size differs from the live one goes
        through the resharder; a same-world (or world-agnostic) resume
        passes the payload through.  No resharder ->
        :class:`WorldSizeMismatchError` naming both counts."""
        template_state = template
        resharder = (self._elastic if self._elastic is not None
                     else get_resharder())
        saved_world = saved_meta.get(META_WORLD_KEY)
        if not saved_world or not live_world:
            if resharder is not None and not saved_meta.get(META_WORLD_KEY):
                warnings.warn(
                    "checkpoint manifest records no world size (written "
                    "by a pre-elastic version): reshard unavailable, "
                    "same-world resume only", ManifestCompatWarning,
                    stacklevel=3)
            return payload
        saved_world, live_world = int(saved_world), int(live_world)
        if saved_world == live_world:
            return payload
        if resharder is None:
            raise WorldSizeMismatchError(saved_world, live_world)
        if not isinstance(saved_meta.get(META_LAYOUT_KEY), dict):
            warnings.warn(
                "checkpoint manifest records no flat-shard layout "
                "(written by a pre-elastic version): reshard "
                "unavailable, same-world resume only",
                ManifestCompatWarning, stacklevel=3)
            raise WorldSizeMismatchError(
                saved_world, live_world,
                detail="manifest lacks the flat-shard layout fields")
        if self._state_shards is not None:
            # the resharder works on canonical payloads: the template
            # carries the live world's canonical shapes
            template = self._canonical_template(template, live_world)
            payload = self._canonical_saved(template_state, payload)
        payload = resharder.resume(template, payload, saved_meta,
                                   live_world, emit=self._emit)
        report.resharded_from = saved_world
        return payload

    # -- the data-plane cursor -----------------------------------------------
    @staticmethod
    def _data_meta(batches) -> Optional[dict]:
        """The batch source's run-level data facts when it speaks the
        seekable protocol (``data.sharded.ShardedLoader.data_meta()``);
        None for synthetic callables and plain iterators."""
        meta_fn = getattr(batches, "data_meta", None)
        if not callable(meta_fn):
            return None
        try:
            meta = meta_fn()
        except Exception:   # a broken probe must not kill the run
            return None
        return meta if isinstance(meta, dict) else None

    def _record_cursor(self, batches, step: int) -> None:
        """Refresh the manifest's data block with the cursor at ``step``,
        so every manifest write names the stream position its newest
        checkpoint resumes at."""
        if self.manager is None:
            return
        cursor_fn = getattr(batches, "cursor", None)
        meta = self._data_meta(batches)
        if meta is None or not callable(cursor_fn):
            return
        try:
            meta = {**meta, "cursor": cursor_fn(int(step))}
        except Exception:
            return
        self.manager.update_meta({META_DATA_KEY: meta})

    @staticmethod
    def _check_data_stream(batches, saved_meta: dict) -> None:
        """A manifest that names a dataset index digest must be resumed
        against the same dataset (:class:`DataStreamMismatchError`
        otherwise); manifests without a data block pass."""
        saved = saved_meta.get(META_DATA_KEY)
        if not isinstance(saved, dict) or not saved.get("index_digest"):
            return
        live = TrainGuard._data_meta(batches)
        if live is None or not live.get("index_digest"):
            return
        if str(live["index_digest"]) != str(saved["index_digest"]):
            raise DataStreamMismatchError(saved["index_digest"],
                                          live["index_digest"])

    # -- signals -------------------------------------------------------------
    def _install_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            return None
        prev = {}

        def handler(signum, frame):
            self._stop = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover - exotic host
                pass
        return prev

    @staticmethod
    def _restore_handlers(prev):
        for sig, old in (prev or {}).items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):  # pragma: no cover
                pass

    # -- the loop ------------------------------------------------------------
    @staticmethod
    def _splitter(state):
        """The ``out -> (new_state, loss)`` splitter for this state: a
        tuple return is ``(new_state, loss, *aux)`` only when it is not
        structurally the state itself (a bare ``(amp_state, bn_state)``
        carry keeps its second element)."""
        state_def = _structure(state) if isinstance(state, tuple) else None

        def split(out) -> Tuple[Any, Optional[Any]]:
            if isinstance(out, tuple) and len(out) >= 2 and (
                    state_def is None or _structure(out) != state_def):
                return out[0], out[1]
            return out, None
        return split

    def run(self, state, batches, num_steps: int, *, start_step: int = 0):
        """Drive steps ``start_step`` .. ``num_steps - 1`` and return
        ``(final_state, GuardReport)``."""
        cfg = self.cfg
        seekable = callable(batches)
        split = self._splitter(state)
        if not cfg.enabled:
            it = None if seekable else iter(batches)
            for step in range(start_step, num_steps):
                batch = batches(step) if seekable else next(it)
                state, _ = split(self.step_fn(state, batch))
            return state, GuardReport(status="disabled",
                                      final_step=num_steps)

        plan = self._plan if self._plan is not None else _faults.active_plan()
        it = None if seekable else iter(batches)
        report = GuardReport(status="completed", final_step=start_step)
        self._report = report   # request_resize targets the live run
        mgr = self.manager
        step = start_step
        # the controller rides the health-check window below; a disabled
        # one is dropped here, so the loop skips every touch point
        ctl = self._controller
        if ctl is not None and not getattr(ctl, "enabled", False):
            ctl = None
        group, group_world, _ = self._shard_group()
        live_world = cfg.world_size or (group_world if group_world > 1
                                        else None)
        if group_world > 1 and cfg.save_every_seconds:
            raise ValueError(
                "save_every_seconds under a process group: each rank's "
                "clock would pick its own save steps; use "
                "save_every_steps")
        self._check_layout(state, group_world)
        writes = self._writes()
        # the live OpenMetrics endpoint: armed only when
        # APEX_TPU_METRICS_PORT is set, shut down at the end iff this run
        # started it
        exp_owned = _export.get_exporter() is None
        reg0 = (self._registry if self._registry is not None
                else _tel_events.get_default())
        exporter = _export.maybe_start(
            run_id=getattr(reg0, "run_id", None) or f"guard-{os.getpid()}")
        exp_owned = exp_owned and exporter is not None
        if exporter is not None:
            exporter.set_meta(world=live_world, pid=os.getpid())
            report.export_url = exporter.url
        if mgr is not None:
            meta = {}
            if live_world:
                meta[META_WORLD_KEY] = int(live_world)
            if cfg.ckpt_meta:
                meta.update(cfg.ckpt_meta)
            data_meta = self._data_meta(batches)
            if data_meta is not None:
                meta[META_DATA_KEY] = data_meta
            if meta:
                mgr.set_meta(meta)

        self._stop = False
        prev_handlers = self._install_handlers()
        writer = None
        pending: List[Tuple[int, Any]] = []   # (step, device loss)
        since_check = 0    # steps since the last boundary: a loss-less
        # step fn must still reach the checkpoint cadence
        self._streak = 0
        self._floor_checks = 0
        self._last_bad_step: Optional[int] = None
        self._last_losses: List[float] = []
        # the run's goodput ledger, streaming off the default tracer's
        # spans and installed as the process ledger; finalised (gauges
        # and GOODPUT.json) in the finally below.  No tracer, no ledger.
        _tel_events.install_compile_listener()
        tracer = _trace.get_tracer()
        ledger = prev_ledger = prev_hook = None
        ctl_writes = True
        if tracer is not None and tracer.enabled:
            ledger = _goodput.GoodputLedger()
            prev_hook = getattr(tracer, "ledger", None)
            ledger.attach(tracer)
            prev_ledger = _goodput.install(ledger)
        try:
            # under a process group rank 0 writes; the others take part
            # in each snapshot's gathers and write nothing
            writer = (_AsyncWriter(mgr, registry=self._registry)
                      if writes else _NullWriter()) \
                if mgr is not None else None
            resumed_meta = None
            if mgr is not None and cfg.auto_resume:
                found = mgr.load_latest(with_meta=True)
                if found is not None and found[0] > start_step:
                    ck_step, payload, saved_meta = found
                    resumed_meta = saved_meta
                    # the stream must be the one the manifest cursor names
                    self._check_data_stream(batches, saved_meta)
                    payload = self._maybe_reshard(state, payload,
                                                  saved_meta, live_world,
                                                  report)
                    with _trace.span("ckpt.restore", step=ck_step):
                        state = self._restore(
                            state, self._local_payload(state, payload))
                    step = min(ck_step, num_steps)
                    seek = getattr(batches, "seek", None)
                    if seekable and callable(seek):
                        seek(step)   # position any prefetch iteration too
                    report.resumed_from = ck_step
                    self._emit("resumed", step=ck_step)
                    if plan is not None:
                        # faults before the resume point fired in the
                        # interrupted run; a re-armed env plan must not
                        # fire them again
                        plan.skip_until(step)
            if ctl is not None:
                # armed after the resume, so that an acted config recorded
                # in the interrupted run's manifest is re-applied before
                # any step runs; every rank decides on rank 0's signals
                sync, ctl_writes = self._control_sync()
                ctl.arm(guard=self, manager=mgr, live_world=live_world,
                        saved_meta=resumed_meta, sync=sync)
            last_saved = step
            t_last_save = time.monotonic()
            if mgr is not None and step < num_steps:
                # the rollback anchor, written inline (the writer is idle
                # this early): the whole save is boundary-blocked
                self._record_cursor(batches, step)
                self._blocked_ckpt(step, lambda: self._save_now(
                    mgr, step, state, writes))
                report.checkpoints += 1
            while step < num_steps:
                if plan is not None and not self._stop:
                    spec = plan.fire("resize", step)
                    if spec is not None:
                        # a simulated fleet resize: snapshot and exit as
                        # a preemption, with the target world recorded
                        report.faults_injected += 1
                        report.resize_to = int(spec.arg)
                        self._emit("fault_injected", kind="resize",
                                   step=step, target_world=int(spec.arg))
                        signal.raise_signal(signal.SIGTERM)
                if plan is not None and not self._stop \
                        and plan.fire("preempt", step) is not None:
                    report.faults_injected += 1
                    self._emit("fault_injected", kind="preempt", step=step)
                    signal.raise_signal(signal.SIGTERM)
                if self._stop:
                    break
                if plan is not None:
                    spec = plan.fire("goodput_degrade", step)
                    if spec is not None:
                        # synthetic badput: a sleep outside any span,
                        # which the goodput ledger counts as idle
                        report.faults_injected += 1
                        self._emit("fault_injected", kind="goodput_degrade",
                                   step=step, seconds=float(spec.arg))
                        time.sleep(float(spec.arg))
                straggler_spec = (plan.fire("straggler", step)
                                  if plan is not None else None)
                if straggler_spec is not None:
                    report.faults_injected += 1
                    self._emit("fault_injected", kind="straggler",
                               step=step, factor=float(straggler_spec.arg))
                if plan is not None and plan.fire("oom", step) is not None:
                    # allocator exhaustion: the raise takes the exception
                    # path below (post-mortem, re-raise), never a rollback
                    report.faults_injected += 1
                    self._emit("fault_injected", kind="oom", step=step)
                    raise _tmem.synthetic_oom(step)
                # the ledger's data_stall stream: the boundary's wait on
                # its batch
                with _trace.span("data.fetch", step=step):
                    batch = batches(step) if seekable else next(it)
                if plan is not None:
                    for kind in ("nan", "inf"):
                        if plan.fire(kind, step) is not None:
                            batch = _faults.corrupt(batch, kind)
                            report.faults_injected += 1
                            self._emit("fault_injected", kind=kind,
                                       step=step)
                t_step = time.perf_counter() if ctl is not None else 0.0
                with _trace.span("train.step", step=step):
                    if straggler_spec is not None:
                        # the slowdown is real step time, inside the span
                        time.sleep(_faults.straggler_delay(
                            straggler_spec.arg))
                    state, loss = split(self.step_fn(state, batch))
                if ctl is not None and live_world and int(live_world) >= 2:
                    # per-rank busy rows for the controller's leave-one-out
                    # straggler naming: host step timing spread over the
                    # world, the armed straggler fault's factor on one
                    # deterministic rank (the plan's seed modulo the world)
                    busy_ms = (time.perf_counter() - t_step) * 1e3
                    devs = {f"d{i}": busy_ms
                            for i in range(int(live_world))}
                    if straggler_spec is not None:
                        culprit = ((plan.seed if plan is not None else 0)
                                   % int(live_world))
                        devs[f"d{culprit}"] = busy_ms * max(
                            float(straggler_spec.arg), 1.0)
                    ctl.feed_device_stats(step, devs)
                if loss is not None:
                    pending.append((step, loss))
                step += 1
                since_check += 1
                if not (since_check >= cfg.check_every
                        or step >= num_steps or self._stop):
                    continue
                with _trace.span("guard.health_check", step=step):
                    healthy = self._health_check(state, pending)
                pending.clear()             # the window is consumed
                since_check = 0
                if healthy and ctl is not None and not self._stop:
                    # the controller decides on the read the health check
                    # just paid for; an action that stops the run
                    # (quarantine) sets self._stop, and the preemption
                    # path below takes it from there
                    with _trace.span("control.window", step=step):
                        ctl.on_window(step=step, losses=self._last_losses)
                if not healthy:
                    if writer is not None:  # newest ckpt must be on disk
                        self._blocked_ckpt(step, writer.drain)
                    state, step = self._rollback(state, report, seekable)
                    last_saved = min(last_saved, step)
                    continue
                if mgr is not None and not self._stop:
                    due = ((cfg.save_every_steps
                            and step - last_saved >= cfg.save_every_steps)
                           or (cfg.save_every_seconds
                               and time.monotonic() - t_last_save
                               >= cfg.save_every_seconds))
                    if due and step < num_steps:
                        self._record_cursor(batches, step)
                        # the snapshot read and the queue hand-off are the
                        # boundary's exposed cost; the write overlaps
                        self._blocked_ckpt(
                            step, lambda: writer.submit(
                                step, self._snapshot(state, step)))
                        report.checkpoints += 1
                        last_saved = step
                        t_last_save = time.monotonic()
            if mgr is not None and (self._stop or cfg.save_on_exit):
                self._blocked_ckpt(step, writer.drain)
                self._record_cursor(batches, step)
                self._blocked_ckpt(step, lambda: self._save_now(
                    mgr, step, state, writes))
                report.checkpoints += 1
            if self._stop:
                report.status = "preempted"
                self._emit("preempted", step=step)
                self._dump_flight("preempt", step)
            report.final_step = step
            if writer is not None:
                self._blocked_ckpt(step, writer.drain)
            if writer is not None and group_world > 1:
                # no rank returns before rank 0's checkpoints are on disk:
                # a rank that reads them next must find the newest
                import torch.distributed as dist
                dist.barrier(group=group)
            return state, report
        except BaseException as e:
            # the crash flight dump (GuardAbort included), or for an OOM
            # the richer post-mortem, before the exception propagates
            report.status = "crashed"   # what the goodput artifact says
            if _tmem.is_oom_error(e):
                self._emit("memory.oom", step=step, error=repr(e)[:200])
                self._dump_oom(step, e)
            else:
                self._dump_flight("exception", step, error=repr(e)[:200],
                                  error_type=type(e).__name__)
            raise
        finally:
            if writer is not None:
                writer.close()
            self._restore_handlers(prev_handlers)
            if ledger is not None:
                self._finalize_goodput(ledger, tracer, prev_hook,
                                       prev_ledger, report)
            if ctl is not None:
                self._finalize_control(ctl, tracer, report, ctl_writes)
            if exp_owned:
                _export.shutdown()
            self._report = None

    # -- health + rollback ---------------------------------------------------
    def _health_check(self, state, pending) -> bool:
        """ONE batched host read over the pending losses (and the loss
        scale); update the non-finite streak and the floor counter.  True
        = keep going, False = escalate to a rollback."""
        cfg = self.cfg
        scaler = (self._scaler_fn(state) if self._scaler_fn is not None
                  else _find_scaler(state))
        values = [loss for _, loss in pending]
        if scaler is not None and cfg.floor_patience:
            values = values + [scaler.loss_scale]
        self._last_losses = []
        if not values:
            return True
        self.host_reads += 1
        self.health_checks += 1
        host = _read_floats(values)
        losses = host[:len(pending)]
        self._last_losses = losses
        for (st, _), v in zip(pending, losses):
            if np.isfinite(v):
                self._streak = 0
                self._last_bad_step = None   # a recovered transient must
                # not be named by a later, unrelated rollback's dump
            else:
                self._streak += 1
                self._last_bad_step = st     # the flight dump names it
        if scaler is not None and cfg.floor_patience:
            from ..amp import scaler as _scaler_mod
            pinned = _scaler_mod.floor_pinned(scaler, host[-1])
            self._floor_checks = self._floor_checks + 1 if pinned else 0
        if self._on_check is not None and pending:
            self._on_check(pending[-1][0] + 1, losses)
        escalate = (self._streak >= cfg.nonfinite_streak
                    or (cfg.floor_patience
                        and self._floor_checks >= cfg.floor_patience))
        return not escalate

    def _rollback(self, state, report: GuardReport, seekable: bool):
        cfg = self.cfg
        why = ("non-finite loss streak" if self._streak
               >= cfg.nonfinite_streak else "loss scale pinned at floor")
        if not seekable:
            raise GuardAbort(
                f"escalation ({why}) needs a rollback, but the batch "
                "source is a plain iterator: pass a callable "
                "batches(step) so rolled-back steps can be replayed")
        if self.manager is None:
            raise GuardAbort(f"escalation ({why}) with no ckpt_dir "
                             "configured: nothing to roll back to")
        report.rollbacks += 1
        if report.rollbacks > cfg.max_retries:
            raise GuardAbort(
                f"rollback budget exhausted ({cfg.max_retries} retries), "
                f"still escalating on {why}")
        group, world, _ = self._shard_group()
        if world > 1:
            # rank 0's writer has drained: every rank reads the same file
            import torch.distributed as dist
            dist.barrier(group=group)
        found = self.manager.load_latest()
        if found is None:
            raise GuardAbort(f"escalation ({why}) but no readable "
                             f"checkpoint under {self.manager.directory}")
        ck_step, payload = found
        with _trace.span("ckpt.restore", step=ck_step, rollback=True):
            state = self._restore(state, self._local_payload(state,
                                                             payload))
        self._streak = 0
        self._floor_checks = 0
        self._emit("rollback", to_step=ck_step, attempt=report.rollbacks,
                   reason=why)
        self._dump_flight("rollback", ck_step, why=why,
                          attempt=report.rollbacks, to_step=ck_step,
                          bad_step=self._last_bad_step)
        self._last_bad_step = None     # consumed by this dump
        # the backoff is part of the rollback's cost: the ledger charges
        # it to restore_replay, not idle
        with _trace.span("guard.backoff", step=ck_step,
                         attempt=report.rollbacks):
            time.sleep(cfg.backoff_seconds * (2 ** (report.rollbacks - 1)))
        return state, ck_step


def _read_floats(values) -> List[float]:
    """``values`` (0-d tensors or numbers) as host floats: the tensors
    stacked in float64 on their device and read in one copy."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([t.detach().reshape(()).to(torch.float64)
                             for t in tensors]).cpu().tolist()
                if tensors else ())
    return [next(read) if isinstance(v, torch.Tensor) else float(v)
            for v in values]
