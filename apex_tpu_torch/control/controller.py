"""``RunController`` — the in-run policy engine that closes the
observe -> decide -> act loop.

Counterpart of ``apex_tpu/control/controller.py``, with its names,
signals, actuators, events and ledger.  The controller rides
:class:`~apex_tpu_torch.resilience.guard.TrainGuard`'s batched health-check
window: the guard calls :meth:`RunController.on_window` once per
``check_every`` boundary, AFTER its one batched host read, and the
controller works only with numbers that read already paid for.  Windowed
goodput and exposed-comm fractions are deltas of the process goodput
ledger's host ``perf_counter`` accounting; straggler naming runs
:func:`~apex_tpu_torch.telemetry.timeline.straggler_rows` over
per-device busy rows the guard feeds from host step timing.  The
controller makes ZERO host reads of its own (this package imports no
torch; ``tests/test_torch_control.py`` checks its source and counts the
reads of a guarded run).  Under a process group the guard arms it with
a ``sync`` that hands every rank global rank 0's window signals (a host
collective, no device read), so that all ranks act alike.  A disabled
controller (``APEX_TPU_CONTROL=0``, or none passed) is a true no-op: the
guard skips every controller touch point, so the run is bitwise the
controller-free one.

Signals evaluated each window (all optional: a policy whose signal is
absent this window resets its streak):

  * ``goodput_fraction``: productive-ms delta / wall-ms delta since the
    previous window (the process goodput ledger must be live, i.e. a
    tracer is attached; TrainGuard arranges that);
  * ``exposed_comm_fraction``: exposed_comm-ms delta / wall-ms delta;
  * ``straggler_windows``: how many CONSECUTIVE windows the same device
    has been named by the leave-one-out z-score over the rows fed by
    :meth:`~RunController.feed_device_stats` /
    :meth:`~RunController.feed_decomposition`;
  * ``plateau_windows``: how many CONSECUTIVE windows the window-mean
    loss failed to improve by a relative 1e-3 (exported as the
    ``loss.plateau_windows`` gauge; no default policy bands on it);
  * ``grad_noise_proxy``: the within-window relative loss spread (sample
    std / |mean|), exported as ``loss.grad_noise_proxy``.

Actions are bounded (``max_actions`` a run), hysteresis-gated
(:mod:`.policy`), rate-limited by per-policy cooldowns, and fail-safe: an
actuator that raises reverts to the pre-action config, records a
``failed_reverted`` decision and a ``control.action_failed`` event, and
the run continues.

Every decision is a ``control.*`` event through the guard's registry
chain (``control.decision`` / ``control.suppressed`` /
``control.action_failed``) and a row in the schema-validated
``CONTROL.json`` ledger (:mod:`.ledger`).

Mid-action durability: every acted config lands in the checkpoint
manifest meta under ``"control"`` (``manager.update_meta``) before the
action returns, so a preempt that lands mid-window resumes with the acted
config re-applied by :meth:`RunController.arm`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from . import ledger as _ledger
from .policy import Policy, PolicyState, default_policies

__all__ = ["ControlActionError", "ControlConfig", "RunController",
           "META_CONTROL_KEY", "RETUNE_LADDER"]

#: the manifest-meta key the acted config persists under (next to the
#: elastic contract's "plan" / "layout" / "world_size" blocks)
META_CONTROL_KEY = "control"

#: comm-retune walks this wire-precision ladder one rung per action
#: (each rung ships fewer bytes per gradient element); at the last
#: rung it halves ``min_bytes`` instead, pulling more buckets under
#: compression
RETUNE_LADDER = ("fp32", "bf16", "int8_blockscale")

#: floor for the min_bytes halving walk — below one lane-aligned block
#: there is nothing left to compress
_MIN_BYTES_FLOOR = 256


class ControlActionError(RuntimeError):
    """An actuator could not act (no actuator registered, missing
    profile/world/device context, or the actuation itself failed).
    Always caught by the controller: the decision records
    ``failed_reverted`` and the run continues on the pre-action
    config."""


def _env_enabled() -> bool:
    from ..telemetry.trace import env_flag   # the one boolean-env parser
    return env_flag("APEX_TPU_CONTROL")


@dataclasses.dataclass
class ControlConfig:
    """Controller knobs.  ``enabled=None`` reads ``APEX_TPU_CONTROL``
    (default on — but the controller only exists when explicitly
    passed to the guard, so the env knob is the kill switch, not the
    ignition).  ``profile`` is the
    :class:`~apex_tpu_torch.parallel.plan.ModelProfile` a mid-run
    ``replan_reshard`` searches with — without one, that action
    degrades to ``failed_reverted`` (searching the flagship default
    mid-run would silently pay an executed profiling step).

    ``straggler_z`` / ``straggler_min_slowdown`` feed straight through
    to :func:`~apex_tpu_torch.telemetry.timeline.straggler_rows`;
    ``straggler_name_fraction`` is how many of a window's fed rows
    must flag the same device before the window "names" it."""
    enabled: Optional[bool] = None
    max_actions: int = 3
    profile: Optional[Any] = None
    straggler_z: float = 3.0
    straggler_min_slowdown: float = 1.2
    straggler_name_fraction: float = 0.5

    def __post_init__(self):
        if self.enabled is None:
            self.enabled = _env_enabled()
        if self.max_actions < 0:
            raise ValueError("max_actions must be >= 0")


# ---------------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------------

def act_comm_retune(ctl: "RunController", policy: Policy,
                    step: int) -> dict:
    """Walk the collective wire one rung down :data:`RETUNE_LADDER`
    through the live per-bucket registry override
    (:func:`~apex_tpu_torch.parallel.collectives.set_live_spec`); at the
    bottom rung, halve the ``min_bytes`` bucket threshold instead so
    smaller buckets join the compressed path.  Takes effect at the
    next engine build (resolve time); reverts the previous live spec
    if persisting the acted config fails."""
    from ..parallel import collectives as _coll
    cur = _coll.get_live_spec()
    cur_name = cur.scheme if cur is not None else "fp32"
    base = cur if cur is not None else _coll.CollectiveSpec()
    try:
        rung = RETUNE_LADDER.index(cur_name)
    except ValueError:
        rung = len(RETUNE_LADDER) - 1
    if rung + 1 < len(RETUNE_LADDER):
        nxt = dataclasses.replace(base, scheme=RETUNE_LADDER[rung + 1])
    else:
        if base.min_bytes <= _MIN_BYTES_FLOOR:
            raise ControlActionError(
                f"comm retune exhausted: already at "
                f"{base.scheme}:min_bytes={base.min_bytes}")
        nxt = dataclasses.replace(
            base, min_bytes=max(_MIN_BYTES_FLOOR, base.min_bytes // 2))
    prev = _coll.set_live_spec(nxt)
    try:
        ctl._record_acted_config({
            "live_collective": f"{nxt.scheme}:block={nxt.block},"
                               f"min_bytes={nxt.min_bytes}"})
    except Exception:
        _coll.set_live_spec(prev)
        raise
    return {"from": cur_name, "to": nxt.scheme,
            "min_bytes": nxt.min_bytes}


def act_replan_reshard(ctl: "RunController", policy: Policy,
                       step: int) -> dict:
    """Mid-run ``plan.search`` at the live chip count
    (:func:`apex_tpu_torch.elastic.replan` — its ``elastic.replan`` span
    meters the search as ``reshard`` badput in the goodput ledger),
    then actuate the winner: persist its knobs to the manifest's
    ``"plan"`` block (the elastic-resume contract — the next resume
    reshards INTO the new plan) and apply its collective scheme as the
    live wire override."""
    if ctl.cfg.profile is None:
        raise ControlActionError(
            "replan_reshard needs ControlConfig.profile (a ModelProfile)"
            " — searching the flagship default mid-run is not safe")
    world = ctl._live_world
    if not world:
        raise ControlActionError("live world size unknown; arm() the "
                                 "controller from a guarded run first")
    from .. import elastic as _elastic
    winner = _elastic.replan(int(world), profile=ctl.cfg.profile,
                             saved_knobs=ctl._saved_knobs,
                             emit=ctl._emit)
    if winner is None:
        raise ControlActionError(
            f"plan.search found no feasible plan at {world} chips")
    knobs = winner.knobs()
    from ..parallel import collectives as _coll
    prev = _coll.set_live_spec(knobs.get("collective_scheme") or None)
    try:
        ctl._record_acted_config(
            {"plan": dict(knobs)},
            extra_meta={"plan": dict(knobs)})
    except Exception:
        _coll.set_live_spec(prev)
        raise
    ctl._saved_knobs = dict(knobs)
    return {"chips": int(world),
            "predicted_step_ms": float(winner.predicted_step_ms),
            "collective_scheme": str(knobs.get("collective_scheme",
                                               "fp32"))}


def act_quarantine(ctl: "RunController", policy: Policy,
                   step: int) -> dict:
    """Resize around the persistently-named straggler: a synthesized
    ``resize@N:M`` through the guard
    (:meth:`~apex_tpu_torch.resilience.guard.TrainGuard.request_resize`) —
    snapshot-then-clean-exit with ``report.resize_to = world - 1``, so
    the harness brings the run back up on the healthy pool and elastic
    reshards the checkpoint, exactly like the injected fault."""
    dev = ctl._named_device
    if dev is None:
        raise ControlActionError("no persistently-named straggler")
    world = ctl._live_world
    if not world or int(world) < 2:
        raise ControlActionError(
            f"cannot quarantine below one device (world={world})")
    if ctl._guard is None:
        raise ControlActionError("no guard attached; quarantine needs "
                                 "the elastic resize path")
    target = int(world) - 1
    ctl._record_acted_config({"quarantined_device": str(dev),
                              "resize_to": target})
    ctl._guard.request_resize(target, step=step,
                              reason=f"straggler {dev}")
    return {"device": str(dev), "from_world": int(world),
            "to_world": target}


DEFAULT_ACTUATORS: Dict[str, Callable] = {
    "comm_retune": act_comm_retune,
    "replan_reshard": act_replan_reshard,
    "quarantine": act_quarantine,
}


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class RunController:
    """See the module docstring.  ``policies`` defaults to
    :func:`~apex_tpu_torch.control.policy.default_policies`; ``actuators``
    extends/overrides :data:`DEFAULT_ACTUATORS` (the pluggability
    surface custom policies act through); ``registry`` pins a telemetry
    registry for ``control.*`` events (default: the process default at
    emit time, the guard's own chain)."""

    def __init__(self, config: Optional[ControlConfig] = None,
                 policies: Optional[List[Policy]] = None, *,
                 registry=None,
                 actuators: Optional[Dict[str, Callable]] = None):
        self.cfg = config if config is not None else ControlConfig()
        self.enabled = bool(self.cfg.enabled)
        self.policies = tuple(policies if policies is not None
                              else default_policies())
        self._registry = registry
        self._actuators = dict(DEFAULT_ACTUATORS)
        if actuators:
            self._actuators.update(actuators)
        self._state = {p.name: PolicyState() for p in self.policies}
        self.windows = 0
        self.decisions: List[dict] = []
        # run-context (arm())
        self._guard = None
        self._manager = None
        self._live_world: Optional[int] = None
        self._saved_knobs: Optional[dict] = None
        self._acted_config: Dict[str, Any] = {}
        self._sync: Optional[Callable] = None
        # signal state
        self._rows: List[dict] = []          # fed since the last window
        self._streak_device: Optional[str] = None
        self._streak = 0
        self._named_device: Optional[str] = None
        self._prev_wall: Optional[float] = None
        self._prev_class_ms: Dict[str, float] = {}
        self._loss_prev_mean: Optional[float] = None
        self._plateau_windows = 0

    # -- run wiring ----------------------------------------------------------
    @property
    def actions_fired(self) -> int:
        return sum(1 for d in self.decisions if d["outcome"] == "acted")

    def arm(self, *, guard=None, manager=None,
            live_world: Optional[int] = None,
            saved_meta: Optional[dict] = None, sync=None) -> None:
        """Attach the controller to a run.  When ``saved_meta`` (the
        resumed checkpoint's manifest meta) carries a ``"control"``
        block from an interrupted run, the acted config is re-applied
        — a preempt that lands after an action but before the next
        save must not silently resume on the pre-action config — and
        re-merged into the new run's manifest meta so it keeps
        surviving saves.  ``sync(payload) -> payload`` (the guard's,
        under a process group) hands every rank one rank's window
        signals, so that all ranks decide alike."""
        self._guard = guard
        self._manager = manager
        self._sync = sync
        if live_world:
            self._live_world = int(live_world)
        saved = (saved_meta or {}).get(META_CONTROL_KEY)
        if isinstance(saved, dict):
            self._acted_config.update(saved)
            spec_text = saved.get("live_collective")
            if spec_text:
                from ..parallel import collectives as _coll
                try:
                    _coll.set_live_spec(str(spec_text))
                    self._emit("control.rearmed",
                               live_collective=str(spec_text))
                except Exception:
                    pass   # an unparseable saved spec must not kill
                           # the resume; the run just starts clean
            if isinstance(saved.get("plan"), dict):
                self._saved_knobs = dict(saved["plan"])
            if manager is not None:
                manager.update_meta(
                    {META_CONTROL_KEY: dict(self._acted_config)})
        if self._saved_knobs is None and isinstance(
                (saved_meta or {}).get("plan"), dict):
            self._saved_knobs = dict(saved_meta["plan"])

    def _record_acted_config(self, patch: dict,
                             extra_meta: Optional[dict] = None) -> None:
        """Merge an acted config into the manifest meta so the NEXT
        checkpoint save carries it (the mid-action-preempt contract)."""
        self._acted_config.update(patch)
        if self._manager is not None:
            meta = {META_CONTROL_KEY: dict(self._acted_config)}
            if extra_meta:
                meta.update(extra_meta)
            self._manager.update_meta(meta)

    # -- telemetry -----------------------------------------------------------
    def _emit(self, name: str, **fields) -> None:
        reg = self._registry
        if reg is None:
            from ..telemetry import events as _events
            reg = _events.get_default()
        if reg is not None and reg.enabled:
            reg.event(name, **fields)
            return
        from ..telemetry import trace as _trace
        _trace.note_event(name, step=fields.get("step"), fields=fields)

    # -- signal feeds --------------------------------------------------------
    def feed_device_stats(self, step: int, devices: Dict[str, Any]) -> None:
        """One per-device busy sample for ``step``: ``{device:
        busy_ms}`` (or ``{device: {"busy_ms": x}}`` — the timeline
        decomposition row shape).  The guard synthesizes these from host
        step timing and the armed straggler fault; a device trace's
        :func:`~apex_tpu_torch.telemetry.timeline.decompose` rows can be
        fed instead via :meth:`feed_decomposition`."""
        row = {}
        for dev, v in devices.items():
            busy = v.get("busy_ms") if isinstance(v, dict) else v
            row[str(dev)] = {"busy_ms": float(busy)}
        self._rows.append({"step": int(step), "devices": row})

    def feed_decomposition(self, decomp: dict) -> None:
        """Feed a :func:`~apex_tpu_torch.telemetry.timeline.decompose`
        result's per-step device rows wholesale."""
        for row in decomp.get("steps", ()):
            if isinstance(row, dict) and row.get("devices"):
                self.feed_device_stats(row.get("step", 0), row["devices"])

    # -- signals -------------------------------------------------------------
    def _goodput_signals(self, sig: Dict[str, float]) -> None:
        from ..telemetry import goodput as _goodput
        led = _goodput.get_ledger()
        if led is None or not led.enabled:
            return
        doc = led.snapshot()   # pure host perf_counter arithmetic
        wall = float(doc["wall_ms"])
        class_ms = {c: float(v["ms"]) for c, v in doc["classes"].items()}
        if self._prev_wall is not None:
            dwall = wall - self._prev_wall
            if dwall > 0:
                dprod = (class_ms.get("productive", 0.0)
                         - self._prev_class_ms.get("productive", 0.0))
                dcomm = (class_ms.get("exposed_comm", 0.0)
                         - self._prev_class_ms.get("exposed_comm", 0.0))
                clamp = lambda x: min(max(x, 0.0), 1.0)  # noqa: E731
                sig["goodput_fraction"] = clamp(dprod / dwall)
                sig["exposed_comm_fraction"] = clamp(dcomm / dwall)
        self._prev_wall = wall
        self._prev_class_ms = class_ms

    #: window-over-window relative improvement below this extends the
    #: plateau streak
    PLATEAU_REL_IMPROVEMENT = 1e-3

    def _loss_signals(self, sig: Dict[str, float],
                      losses: Optional[List[float]]) -> None:
        """``plateau_windows`` / ``grad_noise_proxy`` from the window's
        already-resolved host losses.  Pure float arithmetic on numbers the health check already paid
        for — zero new syncs — exported as ``loss.*`` gauges so they
        stream through the live exporter and land in FLEET.json's
        per-host loss block.  Signals only: no default policy bands on
        them and no new actuator exists."""
        vals = []
        for v in losses or ():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if f == f and f not in (float("inf"), float("-inf")):
                vals.append(f)
        if not vals:
            return
        mean = sum(vals) / len(vals)
        if len(vals) >= 2:
            var = sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
            sig["grad_noise_proxy"] = (var ** 0.5) / max(abs(mean), 1e-12)
        prev, self._loss_prev_mean = self._loss_prev_mean, mean
        if prev is not None:
            rel = (prev - mean) / max(abs(prev), 1e-12)
            if rel < self.PLATEAU_REL_IMPROVEMENT:
                self._plateau_windows += 1
            else:
                self._plateau_windows = 0
            sig["plateau_windows"] = float(self._plateau_windows)
        reg = self._registry
        if reg is None:
            from ..telemetry import events as _events
            reg = _events.get_default()
        if reg is not None and getattr(reg, "enabled", False):
            if "plateau_windows" in sig:
                reg.gauge("loss.plateau_windows").set(
                    sig["plateau_windows"])
            if "grad_noise_proxy" in sig:
                reg.gauge("loss.grad_noise_proxy").set(
                    sig["grad_noise_proxy"])

    def _straggler_signal(self, sig: Dict[str, float]) -> None:
        rows, self._rows = self._rows, []
        if not rows:
            # no measurements this window: the streak cannot be
            # EXTENDED, but an in-flight streak survives one blind
            # window (quarantine evidence should not evaporate because
            # a window had no step timing)
            return
        from ..telemetry import timeline as _timeline
        flagged = _timeline.straggler_rows(
            rows, z_threshold=self.cfg.straggler_z,
            min_slowdown=self.cfg.straggler_min_slowdown)
        counts: Dict[str, int] = {}
        for f in flagged:
            counts[str(f["device"])] = counts.get(str(f["device"]), 0) + 1
        named = None
        if counts:
            dev, n = max(counts.items(), key=lambda kv: kv[1])
            if n >= max(1, int(len(rows)
                               * self.cfg.straggler_name_fraction)):
                named = dev
        if named is None:
            self._streak_device, self._streak = None, 0
        elif named == self._streak_device:
            self._streak += 1
        else:
            self._streak_device, self._streak = named, 1
        self._named_device = self._streak_device
        sig["straggler_windows"] = float(self._streak)

    # -- the window ----------------------------------------------------------
    def on_window(self, step: int, losses: Optional[List[float]] = None,
                  signals: Optional[Dict[str, float]] = None
                  ) -> List[dict]:
        """Evaluate one health-check window at global ``step``.  The
        guard calls this right after its batched host read; ``losses``
        are the already-resolved host floats from that same read,
        folded into the ``plateau_windows`` / ``grad_noise_proxy``
        signals (and ``loss.*`` gauges) by :meth:`_loss_signals`.
        ``signals`` injects/overrides signal values — the harness/test
        surface; live signals are computed first, then overridden.
        Returns this window's decision rows."""
        if not self.enabled:
            return []
        self.windows += 1
        sig: Dict[str, float] = {}
        self._goodput_signals(sig)
        self._loss_signals(sig, losses)
        self._straggler_signal(sig)
        if self._sync is not None:
            # the deciding rank's signals and named straggler, everywhere
            sig, self._named_device = self._sync((sig, self._named_device))
        if signals:
            sig.update({k: float(v) for k, v in signals.items()})
        fired: List[dict] = []
        for pol in self.policies:
            st = self._state[pol.name]
            value = sig.get(pol.signal)
            if value is None or not pol.band.breached(value):
                st.consec = 0
                continue
            st.consec += 1
            if st.consec < pol.k_consecutive:
                continue
            if st.cooldown_left > 0:
                st.cooldown_left -= 1
                fired.append(self._decide(pol, step, value,
                                          "suppressed_cooldown", {}))
                continue
            if self.actions_fired >= self.cfg.max_actions:
                fired.append(self._decide(pol, step, value,
                                          "suppressed_max_actions", {}))
                continue
            outcome, detail = self._fire(pol, step, value)
            st.cooldown_left = pol.cooldown_windows
            st.consec = 0
            fired.append(self._decide(pol, step, value, outcome, detail))
        return fired

    def _fire(self, pol: Policy, step: int, value: float):
        act = self._actuators.get(pol.action)
        try:
            if act is None:
                raise ControlActionError(
                    f"no actuator registered for {pol.action!r}")
            detail = act(self, pol, step) or {}
            return "acted", detail
        except Exception as e:   # fail-safe: the pre-action config
            # stands (each actuator reverts its own partial effects)
            # and the run continues — record + emit, never raise
            self._emit("control.action_failed", step=int(step),
                       policy=pol.name, action=pol.action,
                       error=repr(e)[:200])
            return "failed_reverted", {"error": repr(e)[:200]}

    def _decide(self, pol: Policy, step: int, value: float,
                outcome: str, detail: dict) -> dict:
        row = {"window": int(self.windows), "step": int(step),
               "policy": pol.name, "signal": pol.signal,
               "value": float(value), "lo": pol.band.lo,
               "hi": pol.band.hi, "action": pol.action,
               "outcome": outcome, "detail": dict(detail)}
        self.decisions.append(row)
        event = ("control.decision" if outcome == "acted"
                 else "control.action_failed" if outcome == "failed_reverted"
                 else "control.suppressed")
        if outcome != "failed_reverted":   # _fire already emitted that
            self._emit(event, step=int(step), policy=pol.name,
                       signal=pol.signal, value=float(value),
                       action=pol.action, outcome=outcome)
        return row

    # -- the artifact --------------------------------------------------------
    def snapshot(self, status: Optional[str] = None) -> dict:
        return _ledger.build_doc(
            enabled=self.enabled, windows=self.windows,
            max_actions=self.cfg.max_actions,
            policies=[p.row() for p in self.policies],
            decisions=self.decisions, status=status)

    def write(self, path: Optional[str] = None,
              directory: Optional[str] = None,
              doc: Optional[dict] = None) -> Optional[str]:
        """Write ``CONTROL.json`` (atomic, writer-validates)."""
        return _ledger.write_doc(doc if doc is not None
                                 else self.snapshot(),
                                 path=path, directory=directory)
