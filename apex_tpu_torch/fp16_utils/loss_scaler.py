"""Legacy loss scalers (counterpart of
``apex_tpu/fp16_utils/loss_scaler.py``, the reference's
``loss_scaler.py``), kept for scripts of the pre-amp API; new code uses
:mod:`apex_tpu_torch.amp.scaler`.  The legacy defaults:
``DynamicLossScaler(init_scale=2**32, scale_window=1000)`` where amp's are
2**16 / 2000.  The scale lives on ``device`` (default ``"cuda"``)."""
from __future__ import annotations

import torch

from ..amp import scaler as _scaler

__all__ = ["LossScaler", "DynamicLossScaler"]


class LossScaler:
    """Static scaler."""

    def __init__(self, scale=1.0, *, device=None):
        self.state = _scaler.init(loss_scale=scale, device=device)

    @property
    def loss_scale(self):
        return float(self.state.loss_scale)

    def scale_gradient(self, grads):
        """The gradients divided by the scale, in fp32."""
        out, _ = _scaler.unscale(self.state, grads)
        return out

    def update_scale(self, overflow):
        pass

    def backward(self, loss):
        """The scaled loss (differentiate it in place of ``loss``)."""
        return _scaler.scale_loss(self.state, loss)


class DynamicLossScaler:
    """Dynamic scaler with the legacy defaults."""

    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0,
                 scale_window=1000, *, device=None):
        del scale_factor    # the scaler's policy doubles and halves
        self.state = _scaler.init("dynamic", init_scale=init_scale,
                                  scale_window=scale_window, device=device)

    @property
    def loss_scale(self):
        return float(self.state.loss_scale)

    def has_overflow(self, grads):
        return not bool(_scaler.all_finite(grads))

    def update_scale(self, overflow):
        finite = ~torch.as_tensor(overflow, dtype=torch.bool,
                                  device=self.state.loss_scale.device)
        self.state = _scaler.update(self.state, finite)

    def backward(self, loss):
        """The scaled loss (differentiate it in place of ``loss``)."""
        return _scaler.scale_loss(self.state, loss)
