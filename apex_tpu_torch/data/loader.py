"""The native prefetch loader and the pieces the data plane rides on.

Counterpart of ``apex_tpu/data/loader.py``:

  * :class:`NativeLoader` iterates prefetched ``(x, y)`` batches from the
    C++ ring ``apex_tpu_torch/csrc/prefetch.cpp`` (host code, built with
    the host C++ compiler at first use and bound with ``ctypes``:
    ``utils.build.host_library``).  Worker threads assemble batches in a
    ring of host buffers while the step runs; batches come in ticket
    order, so the stream does not depend on the worker count.
    ``ArraySource`` gathers rows of a caller-owned fp32 array (typically
    ``np.memmap``) in a seeded per-epoch shuffle, reshuffled each epoch;
    ``SyntheticSource`` has the ring generate uniform data and labels.
    Where the library cannot be built (no host compiler,
    :func:`native_available` False) the same contract runs on a Python
    thread, the JAX package's Python engine, with its numbers.
  * Batches come as pinned CPU tensors (``device_put=True``, the default:
    the caller copies them to the card with ``non_blocking=True``) or as
    numpy copies (``device_put=False``, the JAX package's option of that
    name); pinning needs the card.
  * ``wait_timeout`` bounds the consumer's wait for one batch and raises
    the typed :class:`LoaderStallError`; an injected ``loader_stall``
    fault sleeps inside that timed wait.

The rest is the host side the shard-addressed loader
(:mod:`.sharded`) shares: the consumer's timed wait with bounded retries
(:func:`_timed_get`), the stop-aware producer put, and the fault and
telemetry hooks (a single attribute check each when no default registry
or tracer is installed).
"""
from __future__ import annotations

import dataclasses
import ctypes
import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..telemetry import events as _tel_events
from ..telemetry import trace as _trace
from ..utils import build as _build

__all__ = ["NativeLoader", "native_available", "LoaderStallError",
           "SyntheticSource", "ArraySource"]


def _load() -> Optional[ctypes.CDLL]:
    """The prefetch ring's library, or None (the Python engine runs)."""
    return _build.host_library()


def native_available() -> bool:
    """True when the C++ prefetch ring is built and loaded."""
    return _load() is not None


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
    """Uniform [-1, 1) fp32 samples + uniform labels, generated by the
    ring (or by numpy on the Python engine)."""
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


class NativeLoader:
    """Iterator over prefetched ``(x, y)`` batches: x float32 of (batch,
    *source.shape), y int32 of (batch,).

    ``depth``: ring size; ``threads``: C++ fill workers (the stream is the
    same for any count); ``seed``: the shuffle's (or the synthetic data's)
    seed.  ``device_put=True`` hands out pinned CPU tensors, for the
    caller's ``.to(device, non_blocking=True)``; ``False`` numpy copies.
    ``wait_timeout``: seconds the consumer waits for one batch before
    :class:`LoaderStallError` (None = forever).  On the Python engine an
    empty queue is retried ``stall_retries`` times with doubling budgets
    first; the ring's acquire is one uninterruptible C call, so there the
    stall is detected when the acquire returns (no retry applies), as in
    the JAX package."""

    def __init__(self, source, batch_size: int, steps: int, *,
                 depth: int = 3, threads: int = 2, seed: int = 0,
                 device_put: bool = True,
                 wait_timeout: Optional[float] = None,
                 stall_retries: int = 2):
        self.source = source
        self.batch_size = int(batch_size)
        self.steps = int(steps)
        self.depth = int(depth)
        self.threads = int(threads)
        self.seed = int(seed)
        self.device_put = device_put
        self.wait_timeout = (None if wait_timeout is None
                             else float(wait_timeout))
        self.stall_retries = int(stall_retries)
        self._shape = (self.batch_size,) + tuple(source.shape)

    def _out(self, x: np.ndarray, y: np.ndarray):
        """A batch as handed out: pinned tensors (one copy each, from ``x``
        and ``y``, which may be the ring's slot), or numpy copies."""
        if not self.device_put:
            return x.copy(), y.copy()
        xt = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
        yt = torch.empty(y.shape, dtype=torch.int32, pin_memory=True)
        xt.numpy()[...] = x
        yt.numpy()[...] = y
        return xt, yt

    # -- the native ring ----------------------------------------------------
    def __iter__(self):
        lib = _load()
        if lib is None:
            yield from self._iter_python()
            return
        synthetic = isinstance(self.source, SyntheticSource)
        if synthetic:
            base, labels, n_samples = None, None, 1
            n_classes = self.source.n_classes
        else:
            base = self.source.data.ctypes.data_as(ctypes.c_char_p)
            labels = (self.source.labels.ctypes.data_as(ctypes.c_void_p)
                      if self.source.labels is not None else None)
            n_samples, n_classes = self.source.data.shape[0], 1
        h = lib.pf_create(base, labels, n_samples, self.source.sample_bytes,
                          self.batch_size, n_classes, self.depth,
                          self.threads, self.seed)
        if not h:
            yield from self._iter_python()
            return
        try:
            xp, yp, tk = ctypes.c_void_p(), ctypes.c_void_p(), \
                ctypes.c_int64()
            n = int(np.prod(self._shape))
            for step in range(self.steps):
                t0 = time.perf_counter()
                _fault_stall(step)       # injected stall counts as wait
                slot = lib.pf_acquire(h, ctypes.byref(xp), ctypes.byref(yp),
                                      ctypes.byref(tk))
                wait = time.perf_counter() - t0
                # the ring exposes no occupancy count: no depth gauge
                _record_loader(None, wait)
                if slot < 0:
                    break
                if self.wait_timeout is not None and wait > self.wait_timeout:
                    lib.pf_release(h, slot)
                    raise LoaderStallError(
                        f"native loader stalled {wait:.2f}s (> "
                        f"wait_timeout={self.wait_timeout}s) acquiring "
                        f"batch {step}")
                x = np.ctypeslib.as_array(
                    ctypes.cast(xp, ctypes.POINTER(ctypes.c_float)),
                    shape=(n,)).reshape(self._shape)
                y = np.ctypeslib.as_array(
                    ctypes.cast(yp, ctypes.POINTER(ctypes.c_int32)),
                    shape=(self.batch_size,))
                # copied out of the slot before it is released: a worker
                # refills it the moment it is
                out = self._out(x, y)
                lib.pf_release(h, slot)
                yield out
        finally:
            lib.pf_destroy(h)

    # -- the Python engine (the same ring and overlap structure) ------------
    def _iter_python(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        synthetic = isinstance(self.source, SyntheticSource)
        stop = threading.Event()

        def producer():
            try:
                _produce()
            except BaseException as e:  # surface to the consumer: a dead
                # producer with no sentinel would leave q.get() blocked
                _put_checking_stop(q, e, stop)

        def _produce():
            rng = np.random.RandomState(self.seed & 0x7fffffff)
            n = 1 if synthetic else self.source.data.shape[0]
            order = None
            for t in range(self.steps):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                if synthetic:
                    x = rng.uniform(-1, 1, self._shape).astype(np.float32)
                    y = rng.randint(0, self.source.n_classes,
                                    self.batch_size).astype(np.int32)
                else:
                    bpe = max(1, n // self.batch_size)
                    if t % bpe == 0:
                        order = rng.permutation(n)
                    i0 = (t % bpe) * self.batch_size
                    idx = order[[(i0 + i) % n
                                 for i in range(self.batch_size)]]
                    x = self.source.data[idx]
                    y = (self.source.labels[idx]
                         if self.source.labels is not None
                         else np.zeros(self.batch_size, np.int32))
                _note_fill_span(t, time.perf_counter() - t0)
                if not _put_checking_stop(q, (x, y), stop):
                    return
            _put_checking_stop(q, None, stop)

        th = threading.Thread(target=producer, daemon=True,
                              name="apex-tpu-torch-loader")
        th.start()
        try:
            step = 0
            while True:
                item, wait = _timed_get(q, step, self.wait_timeout,
                                        self.stall_retries)
                step += 1
                _record_loader(q.qsize(), wait)
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield self._out(*item)
        finally:
            stop.set()
