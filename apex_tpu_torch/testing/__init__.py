"""Public test harness: the ``apex.testing`` analog.

Counterpart of ``apex_tpu/testing/__init__.py``, with the card in the
TPU's place::

    from apex_tpu_torch import testing

    testing.force_cpu()           # hide the card before CUDA's first use
    with testing.cpu_platform():  # the scoped form
        ...

    @testing.skip_if_no_gpu       # pytest-style decorators
    def test_kernel_on_card(): ...

    @testing.skip_if_cpu
    def test_needs_accelerator(): ...

The skips are decided when the test runs, not when it is decorated, so the
device the harness chose is the one consulted (the reference's
``skipIfRocm`` semantics).  :func:`force_cpu` and :func:`cpu_platform` are
:mod:`apex_tpu_torch.utils.platform`'s: they raise once CUDA is up.
"""
from __future__ import annotations

import functools

from ..utils.platform import (backends_initialized, cpu_platform,
                              force_cpu)

__all__ = ["backends_initialized", "cpu_platform", "force_cpu",
           "skip_if_no_gpu", "skip_if_cpu", "on_gpu"]


def on_gpu() -> bool:
    """Is a CUDA card usable from this process?"""
    try:
        import torch
        return bool(torch.cuda.is_available())
    except Exception:
        return False


def _skip_unless(pred, reason):
    """Call-time skip: ``pred`` is evaluated when the test runs."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not pred():
                import pytest
                pytest.skip(reason)
            return fn(*args, **kwargs)
        return wrapped
    return deco


def skip_if_no_gpu(fn):
    """Skip unless a CUDA card is usable (the JAX ``skip_if_no_tpu``)."""
    return _skip_unless(on_gpu, "requires an NVIDIA GPU")(fn)


def skip_if_cpu(fn):
    """Skip where the port would run on the CPU (plain versions of the
    kernels, gloo collectives)."""
    return _skip_unless(on_gpu, "not meaningful on the CPU")(fn)
