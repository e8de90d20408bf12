"""``apex_tpu_torch.control`` — the run controller.

Counterpart of ``apex_tpu/control``.  Every signal (goodput fractions,
straggler z-scores, exposed-comm fraction) and every actuator (the live
collective-scheme override, ``plan.search``, the elastic ``resize@N:M``
path) already exists in the port; this package closes the loop at run
time.  A :class:`RunController` rides TrainGuard's batched health-check
window (no new host reads: it works on the numbers the guard's one read
a window already paid for), evaluates declarative
:class:`~apex_tpu_torch.control.policy.Policy` bands over the live
signals, and fires bounded, hysteresis-gated actions: a live
collective-wire retune, a mid-run re-plan, or a straggler quarantine
through the elastic resize.  Every decision is a ``control.*`` event and
a row in the schema-validated ``CONTROL.json`` ledger; an action that
fails reverts to the pre-action config and the run goes on; and
``APEX_TPU_CONTROL=0`` (or no controller) is a true no-op: the run is
bitwise the controller-free one, with no extra read.
"""
from .controller import (ControlActionError, ControlConfig,
                         DEFAULT_ACTUATORS, META_CONTROL_KEY,
                         RETUNE_LADDER, RunController, act_comm_retune,
                         act_quarantine, act_replan_reshard)
from .ledger import (ARTIFACT_NAME, OUTCOMES, build_doc,
                     control_violations, format_control, load_artifact,
                     write_doc)
from .policy import (Band, Policy, PolicyState,
                     DEFAULT_EXPOSED_COMM_CEILING, DEFAULT_GOODPUT_FLOOR,
                     DEFAULT_STRAGGLER_WINDOWS, default_policies)

__all__ = [
    "ControlActionError", "ControlConfig", "RunController",
    "DEFAULT_ACTUATORS", "META_CONTROL_KEY", "RETUNE_LADDER",
    "act_comm_retune", "act_quarantine", "act_replan_reshard",
    "ARTIFACT_NAME", "OUTCOMES", "build_doc", "control_violations",
    "format_control", "load_artifact", "write_doc",
    "Band", "Policy", "PolicyState", "default_policies",
    "DEFAULT_EXPOSED_COMM_CEILING", "DEFAULT_GOODPUT_FLOOR",
    "DEFAULT_STRAGGLER_WINDOWS",
]
