"""Loader pieces the shard-addressed data plane rides on.

Counterpart of the host-side part of ``apex_tpu/data/loader.py``: the
typed :class:`LoaderStallError`, the consumer's timed wait with bounded
retries (:func:`_timed_get`), the stop-aware producer put, the fault and
telemetry hooks, and the ``SyntheticSource`` / ``ArraySource``
descriptions.  The JAX package's ``NativeLoader`` (ctypes over
``csrc/prefetch.cpp``) and ``native_available`` are not ported yet.

The telemetry hooks report through ``..telemetry.events`` and
``..telemetry.trace``: a single attribute check each when no default
registry or tracer is installed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..telemetry import events as _tel_events
from ..telemetry import trace as _trace


class LoaderStallError(RuntimeError):
    """The loader waited longer than ``wait_timeout`` for a batch — a
    wedged/stalled input source (or an injected ``loader_stall`` fault).
    Raised so the caller can act instead of hanging silently."""


def _fault_stall(step: int) -> float:
    """Resilience fault-injection shim (``loader_stall`` kind): sleeps
    and returns the injected stall seconds when a fault is scheduled at
    this batch index.  One cheap plan probe per batch when no plan is
    configured; import kept local so the loader stays importable
    without the package root."""
    try:
        from ..resilience import faults as _faults
    except ImportError:  # pragma: no cover - standalone module use
        return 0.0
    return _faults.maybe_stall(step)


def _record_loader(depth, wait_s) -> None:
    """Telemetry loader meter: consumer wait per batch + queue depth
    after the dequeue (also a ``loader.wait`` span when a tracer is
    installed)."""
    _tel_events.record_loader(depth, wait_s)


def _record_retry(batch_index, attempt, waited_s, next_wait_s) -> None:
    """Telemetry for one bounded-retry attempt inside the timed wait
    (``loader.retry`` event + counter): the stall did not escalate YET
    — the consumer is waiting again with a doubled budget."""
    _tel_events.record_loader_retry(batch_index, attempt, waited_s,
                                    next_wait_s)


def _timed_get(q, batch_index: int, wait_timeout, stall_retries: int):
    """The consumer-side dequeue discipline of
    :class:`~apex_tpu_torch.data.sharded.ShardedLoader`: injected
    ``loader_stall`` faults count against the first wait window; an
    empty queue is retried up to ``stall_retries`` times with
    exponentially growing budgets (each attempt metered as a
    ``loader.retry`` event) before the typed :class:`LoaderStallError`;
    a batch that ARRIVES after the total allowed budget is the same
    wedge signal, detected post-hoc.  Returns ``(item, wait_seconds)``.
    """
    import queue as _q
    import time as _time
    t0 = _time.perf_counter()
    _fault_stall(batch_index)    # injected stall counts as wait
    if wait_timeout is None:
        return q.get(), _time.perf_counter() - t0
    allowed = wait_timeout
    budget = max(wait_timeout - (_time.perf_counter() - t0), 0.0)
    attempt = 0
    while True:
        try:
            item = q.get(timeout=budget)
            break
        except _q.Empty:
            if attempt >= stall_retries:
                raise LoaderStallError(
                    f"loader stalled: no batch within {wait_timeout}s "
                    f"(+{attempt} backoff retries) on batch "
                    f"{batch_index}") from None
            attempt += 1
            budget = wait_timeout * (2 ** (attempt - 1))
            allowed += budget
            _record_retry(batch_index, attempt,
                          _time.perf_counter() - t0, budget)
    wait = _time.perf_counter() - t0
    if wait > allowed:
        # a batch that ARRIVED late (e.g. an injected stall with a
        # still-full ring) is the same wedge signal as an empty queue —
        # detect it post-hoc
        raise LoaderStallError(
            f"loader stalled {wait:.2f}s (> wait_timeout={wait_timeout}s"
            + (f" + {attempt} retries" if attempt else "")
            + f") on batch {batch_index}")
    return item, wait


def _note_fill_span(batch_index, fill_s) -> None:
    """Producer-side ``loader.fill`` span: how long each batch took to
    assemble, recorded from the fill thread (a no-op without a
    tracer)."""
    _trace.note_span("loader.fill", fill_s, batch=batch_index)


def _put_checking_stop(q, item, stop) -> bool:
    """put() that wakes up to honor `stop` — a producer blocked on a full
    queue must not outlive an abandoned consumer (it would pin the data
    source for the process lifetime)."""
    import queue as _q
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _q.Full:
            continue
    return False


@dataclasses.dataclass
class SyntheticSource:
    """Uniform [-1, 1) fp32 samples + uniform labels (the JAX package's
    native loader generates them; that loader is not ported yet)."""
    shape: Tuple[int, ...]
    n_classes: int = 1000

    @property
    def sample_bytes(self) -> int:
        return int(np.prod(self.shape)) * 4


@dataclasses.dataclass
class ArraySource:
    """Gather rows of a contiguous fp32 array (e.g. ``np.memmap``).

    data: (N, *shape) float32, C-contiguous.  labels: (N,) int32.
    """
    data: np.ndarray
    labels: Optional[np.ndarray] = None

    def __post_init__(self):
        # A memmap must already be fp32 C-contiguous: converting would
        # silently materialize the whole dataset in RAM (4x on-disk for the
        # common uint8 layout), defeating the no-load contract — fail fast.
        if isinstance(self.data, np.memmap) and (
                self.data.dtype != np.float32
                or not self.data.flags["C_CONTIGUOUS"]):
            raise ValueError(
                "ArraySource memmap must be float32 and C-contiguous "
                f"(got {self.data.dtype}); re-export the dataset rather "
                "than loading it into RAM here.")
        self.data = np.ascontiguousarray(self.data, dtype=np.float32)
        if self.labels is not None:
            if isinstance(self.labels, np.memmap) and \
                    self.labels.dtype != np.int32:
                raise ValueError("ArraySource labels memmap must be int32 "
                                 f"(got {self.labels.dtype}).")
            self.labels = np.ascontiguousarray(self.labels, dtype=np.int32)
            assert self.labels.shape == (self.data.shape[0],)

    @property
    def shape(self):
        return self.data.shape[1:]

    @property
    def sample_bytes(self) -> int:
        return int(np.prod(self.shape)) * 4
