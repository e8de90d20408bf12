"""Profiling shim -- the ``apex.pyprof`` analog over ``torch.profiler``.

Counterpart of the JAX package's ``apex_tpu/pyprof``.  The reference's
pyprof has three parts: (a) ``nvtx.init()`` patches every torch function to
push NVTX ranges; (b) ``parse`` reads the profiler's database; (c) ``prof``
maps kernels to layers and computes FLOPs/bytes.  Here:

  * :func:`annotate` / :func:`annotate_function` name regions of a step: a
    ``torch.profiler.record_function`` range while a capture records
    (:func:`apex_tpu_torch.telemetry.trace.profiler_range`, the range every
    span of the port opens; a capture mirrors it onto the device's
    streams as ``gpu_user_annotation``) plus, once CUDA is initialised,
    an NVTX range;
  * :func:`start_trace` / :func:`stop_trace` / :func:`trace` capture a
    ``torch.profiler`` window (CPU and, where there is a card, CUDA
    activity) and write it as a Chrome trace (``*.pt.trace.json``) under
    ``log_dir``;
  * :mod:`.parse` reads such a trace into per-op self times, :mod:`.prof`
    (and :func:`cost_report`) attributes FLOPs and bytes to a step.

    from apex_tpu_torch import pyprof
    pyprof.init()
    with pyprof.trace("/tmp/trace"):
        for _ in range(4):
            with pyprof.annotate("train.step"):
                state, loss = train_step(state, batch, cfg)

``server`` has no PyTorch counterpart: Kineto's on-demand capture needs
the dynolog daemon, so it raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import functools
import os
import socket

import torch

from ..telemetry import trace as _trace


class _State:
    initialized = False
    trace_dir = None
    profiler = None
    traces = 0
    trace_paths: list = []


_state = _State()   # process-wide, like the reference's patched namespaces


def init(enable_function_stack: bool = False) -> None:
    """API-parity entry point (``pyprof.nvtx.init``).  Nothing is patched:
    ``torch.profiler`` already records every aten op with its shapes.
    This prints the banner and records that profiling was requested
    (:func:`is_initialized`)."""
    print("apex_tpu_torch.pyprof: torch.profiler owns op-level attribution "
          "(every aten op and CUDA kernel is recorded); use "
          "annotate()/start_trace()/stop_trace() for custom ranges.")
    _state.initialized = True


def is_initialized() -> bool:
    return _state.initialized


@contextlib.contextmanager
def annotate(name: str, **attrs):
    """Named range visible in profiler traces: the spans' profiler range
    (:func:`~apex_tpu_torch.telemetry.trace.profiler_range`, a
    ``record_function`` range while a capture records), and an NVTX range
    once CUDA is initialised.  ``attrs`` are appended to the name
    (``name|k=v,...``), as the JAX package forms it."""
    if attrs:
        name = name + "|" + ",".join(f"{k}={v}" for k, v in attrs.items())
    nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
            and torch.cuda.is_initialized() else contextlib.nullcontext())
    with _trace.profiler_range(name), nvtx:
        yield


def annotate_function(fn=None, *, name: str | None = None):
    """Decorator form of :func:`annotate`."""

    def deco(f):
        label = name or getattr(f, "__name__", "fn")

        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            with annotate(label):
                return f(*args, **kwargs)
        return wrapped
    return deco(fn) if fn is not None else deco


def start_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` capture: CPU activity, and CUDA activity
    where there is a card."""
    from torch.profiler import ProfilerActivity, profile
    if _state.profiler is not None:
        raise RuntimeError("a pyprof trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _state.profiler = prof
    _state.trace_dir = log_dir


def stop_trace() -> str:
    """End the capture and write it as
    ``<log_dir>/<host>_<pid>.<n>.pt.trace.json``; returns the path."""
    prof, _state.profiler = _state.profiler, None
    if prof is None:
        raise RuntimeError("no pyprof trace is running")
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(_state.trace_dir, exist_ok=True)
    _state.traces += 1
    path = os.path.join(
        _state.trace_dir,
        f"{socket.gethostname()}_{os.getpid()}.{_state.traces}"
        ".pt.trace.json")
    prof.export_chrome_trace(path)
    _state.trace_paths.append(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Scoped capture: ``with pyprof.trace(dir): ...steps...``"""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def cost_report(fn, *args, **kwargs):
    """FLOPs/bytes/roofline report of one call -- see
    :mod:`apex_tpu_torch.pyprof.prof`."""
    from . import prof as _prof
    return _prof.cost_report(fn, *args, **kwargs)


def server(port: int = 9999):
    """The JAX package's live-attach profiling server.  No counterpart:
    Kineto's on-demand capture needs the dynolog daemon, which the card's
    machine lacks."""
    raise NotImplementedError(
        "pyprof.server: torch.profiler's on-demand capture needs the "
        "dynolog daemon; capture with pyprof.trace(log_dir) instead")
