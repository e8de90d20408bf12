"""Declarative controller policies: a named signal, a tolerance band,
and hysteresis gates in front of a named action.

Counterpart of ``apex_tpu/control/policy.py``, the same classes and
defaults.

The posture is a benchmark trend's tolerance band moved in-process: a
signal is healthy while it sits INSIDE its band
(edges inclusive — a value sitting exactly ON the edge is in-band, so
a signal oscillating at the edge can never flap an action), and a
single excursion is noise, not a regime.  Three gates stand between a
breach and an action:

  * **K-consecutive** — the breach must hold for ``k_consecutive``
    health-check windows in a row; any in-band window resets the count.
  * **Cooldown** — after an action fires, the policy sits out
    ``cooldown_windows`` windows (the actuation needs at least that
    long to show up in the very signals being watched; re-firing
    sooner would chase its own tail).  Suppressed breaches are still
    recorded — an audit trail that shows only the actions taken hides
    the decisions NOT taken.
  * **Max-actions-per-run** — a controller-wide bound shared by every
    policy (:class:`~apex_tpu_torch.control.controller.ControlConfig.
    max_actions`); a run that needs more interventions than that needs
    a human, not a fourth retune.

Pure host arithmetic on floats the guard's batched window already paid
for: this module imports neither torch nor anything of the package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["Band", "Policy", "PolicyState", "default_policies",
           "DEFAULT_EXPOSED_COMM_CEILING", "DEFAULT_GOODPUT_FLOOR",
           "DEFAULT_STRAGGLER_WINDOWS"]

#: exposed-comm fraction above this is a comm-bound regime worth a
#: live scheme retune (the planner's own overlap target is ~0)
DEFAULT_EXPOSED_COMM_CEILING = 0.25
#: windowed goodput fraction below this floor triggers replan+reshard
DEFAULT_GOODPUT_FLOOR = 0.5
#: the same device named by leave-one-out z-scores for more than this
#: many consecutive windows is a persistent straggler (the band is
#: ``hi``: the signal counts windows, so > 1.5 means "2 or more")
DEFAULT_STRAGGLER_WINDOWS = 1.5


@dataclasses.dataclass(frozen=True)
class Band:
    """A tolerance band over one signal.  ``None`` disables that edge.
    ``breached(v)`` is strictly-outside: a value exactly AT an edge is
    IN the band — the no-flap contract for edge-riding signals."""
    lo: Optional[float] = None
    hi: Optional[float] = None

    def __post_init__(self):
        if self.lo is None and self.hi is None:
            raise ValueError("a Band needs at least one edge")
        if (self.lo is not None and self.hi is not None
                and self.lo > self.hi):
            raise ValueError(f"Band lo {self.lo} > hi {self.hi}")

    def breached(self, value: float) -> bool:
        return ((self.lo is not None and value < self.lo)
                or (self.hi is not None and value > self.hi))


@dataclasses.dataclass(frozen=True)
class Policy:
    """One row of the controller's policy table: watch ``signal``, and
    when it breaches ``band`` for ``k_consecutive`` windows (and the
    cooldown and max-actions gates clear), fire ``action`` — one of the
    actuator names the controller registers (``comm_retune`` /
    ``replan_reshard`` / ``quarantine``, plus anything passed in via
    ``RunController(actuators=...)``)."""
    name: str
    signal: str
    band: Band
    action: str
    k_consecutive: int = 2
    cooldown_windows: int = 3

    def __post_init__(self):
        if self.k_consecutive < 1:
            raise ValueError("k_consecutive must be >= 1")
        if self.cooldown_windows < 0:
            raise ValueError("cooldown_windows must be >= 0")

    def row(self) -> dict:
        """The serializable policy-table row ``CONTROL.json`` carries."""
        return {"name": self.name, "signal": self.signal,
                "lo": self.band.lo, "hi": self.band.hi,
                "k_consecutive": self.k_consecutive,
                "cooldown_windows": self.cooldown_windows,
                "action": self.action}


class PolicyState:
    """Per-policy hysteresis bookkeeping (mutable; the frozen Policy
    stays declarative).  ``consec`` counts consecutive breached
    windows; ``cooldown_left`` counts windows still inside the post-
    action cooldown.  A suppressed breach does NOT reset ``consec`` —
    the regime is still breached, and the very next clear window after
    the cooldown should be allowed to act."""

    __slots__ = ("consec", "cooldown_left")

    def __init__(self):
        self.consec = 0
        self.cooldown_left = 0


def default_policies(
        *, exposed_comm_ceiling: float = DEFAULT_EXPOSED_COMM_CEILING,
        goodput_floor: float = DEFAULT_GOODPUT_FLOOR,
        straggler_windows: float = DEFAULT_STRAGGLER_WINDOWS,
        k_consecutive: int = 2,
        cooldown_windows: int = 3) -> List[Policy]:
    """The stock signal->action matrix:

    ==========================  =========================  ==============
    signal                      band                       action
    ==========================  =========================  ==============
    ``exposed_comm_fraction``   <= exposed_comm_ceiling    comm_retune
    ``goodput_fraction``        >= goodput_floor           replan_reshard
    ``straggler_windows``       <= straggler_windows       quarantine
    ==========================  =========================  ==============
    """
    return [
        Policy(name="exposed_comm_ceiling",
               signal="exposed_comm_fraction",
               band=Band(hi=float(exposed_comm_ceiling)),
               action="comm_retune",
               k_consecutive=k_consecutive,
               cooldown_windows=cooldown_windows),
        Policy(name="goodput_floor",
               signal="goodput_fraction",
               band=Band(lo=float(goodput_floor)),
               action="replan_reshard",
               k_consecutive=k_consecutive,
               cooldown_windows=cooldown_windows),
        Policy(name="straggler_quarantine",
               signal="straggler_windows",
               band=Band(hi=float(straggler_windows)),
               action="quarantine",
               k_consecutive=1,   # the signal is itself K-consecutive
               cooldown_windows=cooldown_windows),
    ]
