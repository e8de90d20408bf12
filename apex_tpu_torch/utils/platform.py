"""Backend bring-up for the port's entry points.

Counterpart of ``apex_tpu/utils/platform.py``.  The JAX helpers pin the
CPU platform (``JAX_PLATFORMS``), clear and re-create jax's backends, and
probe a remote TPU backend in a killable subprocess.  Here the backend is
CUDA:

- :func:`backends_initialized` is ``torch.cuda.is_initialized()``; the
  tuning profile's :func:`~apex_tpu_torch.utils.tuning.get_on_gpu` asks it,
  so reading a knob never brings the card up.
- :func:`force_cpu` / :func:`cpu_platform` hide the card from a process
  that has not brought CUDA up, through ``CUDA_VISIBLE_DEVICES``, which
  CUDA reads once, at its first use in the process (and every child
  process inherits).  ``cpu_platform`` restores the variable on exit.
  Both raise once CUDA is initialised: torch cannot take a live CUDA
  context down, where the JAX helpers clear their backends.
- :func:`probe_ambient_backend` brings CUDA up in a subprocess that a
  timeout can kill and reports how it went (:class:`ProbeResult`).
- :func:`ensure_live_backend` returns ``"cuda"`` after a good probe and
  raises with the probe's detail after a bad one.  The JAX helper pins
  the CPU there instead; the port refuses to, because a silent fallback
  would hide the card from a run that asked for it.  A caller that wants
  the CPU says so (:func:`force_cpu`, or ``device="cpu"``).
- :func:`enable_compile_cache` points the kernel build cache
  (:data:`apex_tpu_torch.utils.build.BUILD_ROOT`) at a directory: the
  port's persistent compilation cache, on in every process, where a
  library built once for the sources' hash is loaded, not rebuilt.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

__all__ = ["backends_initialized", "force_cpu", "cpu_platform",
           "ProbeResult", "probe_ambient_backend", "ensure_live_backend",
           "enable_compile_cache", "HIDE_ENV"]

#: the variable that hides the card from CUDA's first use in a process
HIDE_ENV = "CUDA_VISIBLE_DEVICES"

#: what the probe's subprocess runs: CUDA up, one allocation, a sync
_PROBE = ("import torch; torch.cuda.init(); "
          "torch.zeros(1, device='cuda'); torch.cuda.synchronize()")


def backends_initialized() -> bool:
    """Has this process brought CUDA up?  Never brings it up."""
    try:
        import torch
        return bool(torch.cuda.is_initialized())
    except Exception:   # a broken probe reads as "not initialised"
        return False


def _refuse_live(what: str) -> None:
    if backends_initialized():
        raise RuntimeError(
            f"{what}: CUDA is already initialised in this process, and "
            "torch cannot take a live CUDA context down; hide the card "
            "before CUDA's first use, or run the CPU work in a process of "
            "its own")


def force_cpu(n_devices: Optional[int] = None) -> None:
    """Hide the card from this process (``CUDA_VISIBLE_DEVICES=""``) before
    CUDA's first use: ``torch.cuda.is_available()`` then reads False and
    the port's entry points need ``device="cpu"``.

    ``n_devices``: the JAX helper's count of virtual CPU devices.  A CPU
    world of N ranks in the port is N processes on the gloo backend
    (``torch.distributed.init_process_group("gloo", ...)``), each with one
    CPU device, so the count is checked (a positive int or None) and
    otherwise asks nothing of this process.  Raises once CUDA is up."""
    if n_devices is not None and int(n_devices) < 1:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    _refuse_live("force_cpu")
    os.environ[HIDE_ENV] = ""


@contextlib.contextmanager
def cpu_platform(n_devices: Optional[int] = None):
    """Scoped :func:`force_cpu`: ``CUDA_VISIBLE_DEVICES`` is restored on
    exit (unset again if it was unset), so processes started after the
    scope see the card.  Raises at entry once CUDA is up, and CUDA must
    not come up inside the scope: the process would keep the hidden
    view."""
    saved = os.environ.get(HIDE_ENV)
    force_cpu(n_devices)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(HIDE_ENV, None)
        else:
            os.environ[HIDE_ENV] = saved


class ProbeResult:
    """Truthy iff the probe succeeded; ``detail`` keeps how it failed (the
    exit code and the tail of stderr, or the timeout)."""

    def __init__(self, ok: bool, detail: str):
        self.ok = ok
        self.detail = detail

    def __bool__(self) -> bool:
        return self.ok

    def __repr__(self) -> str:
        return f"ProbeResult(ok={self.ok}, detail={self.detail!r})"


def probe_ambient_backend(timeout: float = 75.0) -> ProbeResult:
    """Bring CUDA up in a fresh subprocess within ``timeout`` seconds (one
    allocation on the card and a synchronize); a hung driver is killed
    with the subprocess, not with this process."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, timeout=timeout)
        if r.returncode == 0:
            return ProbeResult(True, "ok")
        tail = (r.stderr or b"")[-300:].decode("utf-8", "replace").strip()
        return ProbeResult(
            False, f"probe exited rc={r.returncode}: {tail or '<no stderr>'}")
    except subprocess.TimeoutExpired:
        return ProbeResult(False, f"probe timeout after {timeout:.0f}s")
    except Exception as e:
        return ProbeResult(False, f"probe failed to launch: {e!r}")


def ensure_live_backend(probe_timeout: float = 75.0) -> str:
    """The backend this process will run on: ``"cuda"`` when CUDA is up
    already or a probe brings it up, ``"cpu"`` when the card was hidden on
    purpose (:func:`force_cpu`).  A failed probe raises ``RuntimeError``
    with its detail: the JAX helper pins the CPU there, which here would
    hide the card from a run that asked for it."""
    if backends_initialized():
        return "cuda"
    if os.environ.get(HIDE_ENV) == "":
        return "cpu"
    probe = probe_ambient_backend(probe_timeout)
    if probe:
        return "cuda"
    raise RuntimeError(f"no live CUDA backend ({probe.detail}); pass "
                       "device='cpu' (or call force_cpu()) to run on the "
                       "CPU")


def enable_compile_cache(default_dir: Optional[str] = None) -> Path:
    """The kernel build cache's directory, moved to ``default_dir`` when
    given; returns it.  The cache is always on: :func:`~apex_tpu_torch.
    utils.build.build` loads the library built for the sources' hash and
    flags when one exists there."""
    from . import build
    if default_dir is not None:
        build.BUILD_ROOT = Path(default_dir)
    return build.BUILD_ROOT
