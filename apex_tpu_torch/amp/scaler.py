"""Dynamic / static loss scaling as state carried through the step.

Counterpart of ``apex_tpu/amp/scaler.py``: the scaler is a small state of
device tensors, and the skip-on-overflow decision is a ``torch.where`` over
the update, so the step needs no host read.  Policy: x2 after
``scale_window`` consecutive finite steps, /2 on overflow, clamped to
[min_loss_scale, max_loss_scale].
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.pytree import tree_leaves, tree_map

__all__ = ["ScalerState", "LossScaler", "init", "scale_loss", "all_finite",
           "unscale", "unscale_with_stashed", "update", "transition_kind",
           "floor_pinned", "apply_if_finite", "state_dict", "load_state_dict"]


@dataclasses.dataclass(frozen=True)
class ScalerState:
    loss_scale: torch.Tensor      # 0-d fp32
    unskipped: torch.Tensor       # 0-d int32: consecutive finite steps
    dynamic: bool = True
    scale_window: int = 2000
    min_loss_scale: float = 1.0
    max_loss_scale: float = 2.0 ** 24

    @property
    def scale(self):
        return self.loss_scale

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init(loss_scale="dynamic", init_scale=2.0 ** 16, scale_window=2000,
         min_loss_scale=1.0, max_loss_scale=2.0 ** 24, *,
         device=None) -> ScalerState:
    """``loss_scale`` is "dynamic" or a static float.  The state's tensors
    live on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    dynamic = loss_scale == "dynamic"
    scale0 = init_scale if dynamic else float(loss_scale)
    return ScalerState(
        loss_scale=torch.tensor(scale0, dtype=torch.float32, device=dev),
        unskipped=torch.zeros((), dtype=torch.int32, device=dev),
        dynamic=dynamic, scale_window=int(scale_window),
        min_loss_scale=float(min_loss_scale),
        max_loss_scale=float(max_loss_scale))


def scale_loss(state: ScalerState, loss: torch.Tensor) -> torch.Tensor:
    """loss * scale, in fp32."""
    return loss.float() * state.loss_scale


def all_finite(tree) -> torch.Tensor:
    """0-d bool: every element of every leaf is finite."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(l).all() for l in leaves]).all()


def unscale(state: ScalerState, grads, *, check_finite=True):
    """(grads * (1/scale) in fp32, finite); ``check_finite=False`` skips
    the check and reports True."""
    inv = 1.0 / state.loss_scale
    finite = (all_finite(grads) if check_finite else
              torch.ones((), dtype=torch.bool, device=inv.device))
    return tree_map(lambda g: g.float() * inv, grads), finite


def unscale_with_stashed(state: ScalerState, new_grads, stashed_grads):
    """The gradient-accumulation form: (stashed + new * (1/scale) in fp32,
    finite of ``new_grads``)."""
    inv = 1.0 / state.loss_scale
    out = tree_map(lambda n, s: s.float() + n.float() * inv, new_grads,
                   stashed_grads)
    return out, all_finite(new_grads)


def update(state: ScalerState, finite) -> ScalerState:
    """The scale-update policy, branch-free."""
    if not state.dynamic:
        return state
    halved = torch.clamp(state.loss_scale / 2.0, min=state.min_loss_scale)
    grown_count = state.unskipped + 1
    should_grow = grown_count >= state.scale_window
    grown = torch.where(
        should_grow,
        torch.clamp(state.loss_scale * 2.0, max=state.max_loss_scale),
        state.loss_scale)
    new_scale = torch.where(finite, grown, halved)
    new_unskipped = torch.where(finite & ~should_grow, grown_count,
                                torch.zeros_like(grown_count))
    return state._replace(loss_scale=new_scale, unskipped=new_unskipped)


def transition_kind(prev_scale: float, new_scale: float,
                    prev_unskipped: int, new_unskipped: int,
                    scale_window: Optional[int] = None,
                    min_loss_scale: Optional[float] = None,
                    max_loss_scale: Optional[float] = None) -> str:
    """Classify one :func:`update` from host-read scalars: ``"overflow"``
    (halved, or pinned at min_loss_scale with the streak reset),
    ``"grew"`` (doubled) or ``"steady"``.  An unchanged scale with the
    streak reset is either a halve clamped at the floor or a double
    clamped at the ceiling: at the floor (and not also at the ceiling) it
    is an overflow; otherwise ``scale_window`` decides (a reset at
    window - 1 is the clamped grow).  A second overflow at the floor
    changes nothing observable and reads "steady"."""
    if new_scale < prev_scale:
        return "overflow"
    if new_scale > prev_scale:
        return "grew"
    if new_unskipped == 0 and new_unskipped < prev_unskipped:
        at_min = min_loss_scale is not None and prev_scale <= min_loss_scale
        at_max = max_loss_scale is not None and prev_scale >= max_loss_scale
        if at_min and not at_max:
            return "overflow"
        if scale_window is not None and prev_unskipped + 1 >= scale_window:
            return "steady"
        return "overflow"
    return "steady"


def floor_pinned(state: ScalerState, scale_value: float) -> bool:
    """True when a dynamic scaler's already-read ``scale_value`` sits at
    its floor, where halving can no longer answer non-finite gradients (a
    static scaler never is)."""
    return bool(state.dynamic) and scale_value <= state.min_loss_scale


def apply_if_finite(finite, new_tree, old_tree):
    """Skip-step: the updated tree where grads were finite, else the old."""
    return tree_map(lambda n, o: torch.where(finite, n, o.to(n.dtype)),
                    new_tree, old_tree)


def state_dict(state: ScalerState) -> dict:
    """The scaler as plain Python values (reads the scale and the count
    from the device), the JAX package's layout."""
    return {
        "loss_scale": float(state.loss_scale),
        "unskipped": int(state.unskipped),
        "dynamic": state.dynamic,
        "scale_window": state.scale_window,
        "min_loss_scale": state.min_loss_scale,
        "max_loss_scale": state.max_loss_scale,
    }


def load_state_dict(d: dict, *, device=None) -> ScalerState:
    """A :func:`state_dict` back into a state on ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)
    return ScalerState(
        loss_scale=torch.tensor(float(d["loss_scale"]), dtype=torch.float32,
                                device=dev),
        unskipped=torch.tensor(int(d["unskipped"]), dtype=torch.int32,
                               device=dev),
        dynamic=bool(d["dynamic"]), scale_window=int(d["scale_window"]),
        min_loss_scale=float(d["min_loss_scale"]),
        max_loss_scale=float(d["max_loss_scale"]))


class LossScaler:
    """Object facade over the scaler functions, shaped like the reference
    class for scripts ported from it: holds a :class:`ScalerState` on
    ``device`` (default ``"cuda"``) and delegates every operation."""

    def __init__(self, loss_scale="dynamic", init_scale=2.0 ** 16,
                 scale_window=2000, min_loss_scale=1.0,
                 max_loss_scale=2.0 ** 24, *, device=None):
        self.state = init(loss_scale, init_scale, scale_window,
                          min_loss_scale, max_loss_scale, device=device)

    def loss_scale(self):
        return float(self.state.loss_scale)

    def scale_loss(self, loss):
        return scale_loss(self.state, loss)

    def unscale(self, grads):
        return unscale(self.state, grads)

    def update_scale(self, finite):
        """Update from ``finite``; returns True when the step should be
        skipped."""
        self.state = update(self.state, finite)
        return not bool(finite)

    def state_dict(self):
        return state_dict(self.state)

    def load_state_dict(self, d):
        self.state = load_state_dict(d, device=self.state.loss_scale.device)
