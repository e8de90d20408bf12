"""The legacy amp handle API: ``AmpHandle``, ``NoOpHandle``,
``OptimWrapper`` and ``init_handle``.

Counterpart of ``apex_tpu/amp/handle.py``.  The handle owns loss-scaler
state and exposes the scale / unscale / skip pipeline as explicit calls
(no ``.grad`` mutation, no patched ``step``)::

    handle = amp.init_handle(loss_scale="dynamic")
    scaled = handle.scale_loss(loss)          # take its gradients
    grads32, skip = handle.unscale_and_update(grads)
    if not skip:
        params, opt_state = opt.step(opt_state, grads32, params)

``OptimWrapper`` (from ``handle.wrap_optimizer(opt, num_loss=n)``) keeps
one dynamic scaler per loss for the multi-loss flow.  The scalers live on
``device`` (default ``"cuda"``); ``unscale_and_update`` reads the overflow
flag on the host.
"""
from __future__ import annotations

import contextlib

from . import scaler as _scaler

__all__ = ["AmpHandle", "NoOpHandle", "OptimWrapper", "init_handle"]


class AmpHandle:
    """Stateful convenience over the scaler functions."""

    def __init__(self, loss_scale="dynamic", enable_caching=True,
                 verbose=False, *, device=None):
        self._enable_caching = enable_caching
        self._verbose = verbose
        self._device = device
        self._scaler_state = _scaler.init(loss_scale, device=device)
        self._is_active = True
        self._wrapped = False

    def is_active(self):
        return self._is_active

    @contextlib.contextmanager
    def _disable_casts(self):
        self._is_active = False
        yield
        self._is_active = True

    @property
    def loss_scale(self):
        return float(self._scaler_state.loss_scale)

    def scale_loss(self, loss):
        """The scaled loss to take gradients of."""
        if not self._is_active:
            return loss
        if self._wrapped:
            raise RuntimeError(
                "After calling `handle.wrap_optimizer()`, use "
                "`wrapper.scale_loss(loss, loss_id)`")
        return _scaler.scale_loss(self._scaler_state, loss)

    def unscale_and_update(self, grads):
        """Unscale ``grads`` and update the dynamic scale from their
        overflow check: ``(grads32, should_skip)``."""
        g32, finite = _scaler.unscale(self._scaler_state, grads)
        self._scaler_state = _scaler.update(self._scaler_state, finite)
        return g32, not bool(finite)

    def wrap_optimizer(self, optimizer, num_loss=1):
        self._wrapped = True
        return OptimWrapper(optimizer, self, num_loss)

    @property
    def has_cache(self):
        return self._enable_caching

    @property
    def verbose(self):
        return self._verbose

    def state_dict(self):
        return {"loss_scaler0": _scaler.state_dict(self._scaler_state)}

    def load_state_dict(self, d):
        self._scaler_state = _scaler.load_state_dict(
            d["loss_scaler0"], device=self._scaler_state.loss_scale.device)


class NoOpHandle:
    """The handle of disabled amp: everything passes through."""

    def is_active(self):
        return False

    @contextlib.contextmanager
    def _disable_casts(self):
        yield

    def scale_loss(self, loss):
        return loss

    def unscale_and_update(self, grads):
        return grads, False

    def wrap_optimizer(self, optimizer, num_loss=1):
        return optimizer

    @property
    def has_cache(self):
        return False


class OptimWrapper:
    """One dynamic scaler per loss_id for the legacy multi-loss flow; the
    caller accumulates the unscaled gradients and steps once.  Other
    attributes are the wrapped optimizer's."""

    def __init__(self, optimizer, amp_handle, num_loss=1):
        self._optimizer = optimizer
        self._handle = amp_handle
        self._scalers = [_scaler.init("dynamic", device=amp_handle._device)
                         for _ in range(num_loss)]

    def loss_scale(self, loss_id=0):
        return float(self._scalers[loss_id].loss_scale)

    def scale_loss(self, loss, loss_id=0):
        if not self._handle.is_active():
            return loss
        return _scaler.scale_loss(self._scalers[loss_id], loss)

    def unscale_and_update(self, grads, loss_id=0):
        g32, finite = _scaler.unscale(self._scalers[loss_id], grads)
        self._scalers[loss_id] = _scaler.update(self._scalers[loss_id],
                                                finite)
        return g32, not bool(finite)

    def __getattr__(self, name):
        return getattr(self._optimizer, name)


def init_handle(loss_scale="dynamic", enabled=True, enable_caching=True,
                verbose=False, *, device=None):
    """The ``amp.init()``-era entry point: a handle (a no-op one when not
    ``enabled``) whose scalers live on ``device`` (default ``"cuda"``)."""
    if not enabled:
        return NoOpHandle()
    return AmpHandle(loss_scale, enable_caching, verbose, device=device)
