"""The port's run controller (``apex_tpu_torch.control``) against the JAX
package's ``apex_tpu.control``.

- Decisions: on the same signal sequences (hypothesis draws the values,
  absent signals, bands, ``k_consecutive``, cooldowns and
  ``max_actions``) both controllers take the same decisions, window for
  window, and snapshot the same ledger; the band edge never flaps; the
  loss-window signals (plateau streak, noise proxy) and the straggler
  streak over fed rows come out as JAX's.
- The ledger: ``build_doc``, ``control_violations`` and
  ``format_control`` equal the JAX ones; each package's auditor accepts
  the other's ``CONTROL.json`` and catches the same tampering; the CLI
  (``python -m apex_tpu_torch.telemetry control``) renders it.
- Actuators: the retune ladder walks fp32 -> bf16 -> int8_blockscale,
  then halves ``min_bytes``, through ``collectives.set_live_spec`` as
  JAX's does; a failing action reverts the live spec and records
  ``failed_reverted``; a replan without a profile and a quarantine
  without context degrade the same way.
- With the guard: a disabled controller is a bitwise no-op with the same
  host reads; an enabled one adds no read (every ``.cpu()`` of the run is
  a check or a snapshot); the three chaos scenarios of ``tests/L0/
  test_control.py`` (goodput_degrade -> one replan_reshard acted and
  reshard badput metered; straggler -> quarantine through a synthesized
  ``resize@8:7``; a mid-action preempt that re-arms the acted wire) give
  the JAX guard's decisions.  A source check finds no ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float(`` of a tensor or
  torch import in ``apex_tpu_torch/control/``.
- Under a process group (two spawned gloo ranks whose goodput differs)
  every rank decides on rank 0's signals: the same decisions and the same
  wire spec on both, CONTROL.json from rank 0 alone.
"""
import json
import os
import re

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
import torch

import apex_tpu.control as jc
from apex_tpu.control import ledger as jledger
from apex_tpu.parallel import collectives as jcoll
from apex_tpu.parallel import plan as jplan
from apex_tpu.resilience import CheckpointManager as JManager
from apex_tpu.resilience import GuardConfig as JGuardConfig
from apex_tpu.resilience import TrainGuard as JTrainGuard
from apex_tpu.resilience import faults as jfaults
from apex_tpu.telemetry import MemorySink as JMemorySink
from apex_tpu.telemetry import Registry as JRegistry
from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry import goodput as jgoodput
from apex_tpu.telemetry import trace as jtrace

import _torch_dist
import apex_tpu_torch.control as pc
from apex_tpu_torch.control import ledger as pledger
from apex_tpu_torch.parallel import collectives as pcoll
from apex_tpu_torch.parallel import plan as pplan
from apex_tpu_torch.resilience import (CheckpointManager, GuardConfig,
                                       TrainGuard, faults)
from apex_tpu_torch.telemetry import MemorySink, Registry, events, goodput
from apex_tpu_torch.telemetry import report as preport
from apex_tpu_torch.telemetry import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PROFILE = dict(
    name="tiny", flops=1e9, bytes_accessed=1e8, params_bytes=1 << 20,
    optimizer_bytes=3 << 20, activations_bytes=1 << 20,
    batch_bytes=1 << 16, temps_bytes=1 << 18, output_bytes=1 << 10,
    platform="cpu")
PKGS = {"jax": jc, "port": pc}


@pytest.fixture(autouse=True)
def _clean_state():
    prev = (trace.set_tracer(None), events.set_default(None),
            goodput.install(None), faults.install(None),
            pcoll.set_live_spec(None), jtrace.set_tracer(None),
            jevents.set_default(None), jgoodput.install(None),
            jfaults.install(None), jcoll.set_live_spec(None))
    yield
    trace.set_tracer(prev[0])
    events.set_default(prev[1])
    goodput.install(prev[2])
    faults.install(prev[3])
    pcoll.set_live_spec(prev[4])
    jtrace.set_tracer(prev[5])
    jevents.set_default(prev[6])
    jgoodput.install(prev[7])
    jfaults.install(prev[8])
    jcoll.set_live_spec(prev[9])


def _recording(calls):
    def act(ctl, pol, step):
        calls.append(int(step))
        return {"n": len(calls)}
    return act


def _no_ts(doc):
    return {k: v for k, v in doc.items() if k != "ts"}


def _both(make_policies, max_actions, windows, actions):
    """Run the same windows through both controllers, each action wired
    to a recording actuator; (rows, calls, snapshot) per package."""
    out = {}
    for name, pkg in PKGS.items():
        calls = []
        ctl = pkg.RunController(
            pkg.ControlConfig(enabled=True, max_actions=max_actions),
            make_policies(pkg), actuators={a: _recording(calls)
                                           for a in actions})
        rows = [ctl.on_window(step=w, signals=sig)
                for w, sig in enumerate(windows)]
        out[name] = (rows, calls, _no_ts(ctl.snapshot(status="completed")))
    return out


# ---------------------------------------------------------------------------
# policies, bands, hysteresis: the JAX decisions
# ---------------------------------------------------------------------------

_band = st.tuples(st.one_of(st.none(), st.floats(0, 1)),
                  st.one_of(st.none(), st.floats(0, 1))).filter(
    lambda b: b != (None, None) and (None in b or b[0] <= b[1]))
_policy = st.fixed_dictionaries({
    "band": _band, "k": st.integers(1, 3), "cd": st.integers(0, 3),
    "signal": st.sampled_from(["a", "b"])})
_window = st.dictionaries(st.sampled_from(["a", "b"]),
                          st.sampled_from([0.0, 0.25, 0.5, 0.75, 1.0, 0.1,
                                           0.9]), max_size=2)


@settings(max_examples=80, deadline=None, database=None)
@given(pols=st.lists(_policy, min_size=1, max_size=3),
       windows=st.lists(_window, max_size=14),
       max_actions=st.integers(0, 4))
def test_decisions_match_jax(pols, windows, max_actions):
    def make(pkg):
        return [pkg.Policy(name=f"p{i}", signal=p["signal"],
                           band=pkg.Band(lo=p["band"][0], hi=p["band"][1]),
                           action=f"act{i % 2}", k_consecutive=p["k"],
                           cooldown_windows=p["cd"])
                for i, p in enumerate(pols)]
    out = _both(make, max_actions, windows, ["act0", "act1"])
    assert out["port"] == out["jax"]
    assert pc.control_violations(out["port"][2]) == []


def test_band_validation_edge_and_no_flap():
    for pkg in PKGS.values():
        with pytest.raises(ValueError):
            pkg.Band()
        with pytest.raises(ValueError):
            pkg.Band(lo=0.5, hi=0.25)
        with pytest.raises(ValueError):
            pkg.Policy(name="p", signal="s", band=pkg.Band(hi=1),
                       action="a", k_consecutive=0)
    b = pc.Band(lo=0.25, hi=0.75)
    assert not b.breached(0.25) and not b.breached(0.75)
    assert b.breached(0.2499) and b.breached(0.7501)
    windows = [{"a": 0.25 if w % 2 else 0.10} for w in range(50)]
    out = _both(lambda pkg: [pkg.Policy(
        name="p", signal="a", band=pkg.Band(hi=0.25), action="act0",
        k_consecutive=1, cooldown_windows=0)], 100, windows, ["act0"])
    assert out["port"][1] == [] == out["jax"][1]


def test_cooldown_refire_then_max_actions_as_jax():
    out = _both(lambda pkg: [pkg.Policy(
        name="p", signal="a", band=pkg.Band(hi=0.25), action="act0",
        k_consecutive=2, cooldown_windows=2)], 2, [{"a": 0.9}] * 10,
        ["act0"])
    assert out["port"] == out["jax"]
    assert [[r["outcome"] for r in rows] for rows in out["port"][0]] == [
        [], ["acted"], [], ["suppressed_cooldown"], ["suppressed_cooldown"],
        ["acted"], [], ["suppressed_cooldown"], ["suppressed_cooldown"],
        ["suppressed_max_actions"]]


def test_default_policies_and_config_match_jax(monkeypatch):
    assert [p.row() for p in pc.default_policies()] == \
        [p.row() for p in jc.default_policies()]
    assert [p.row() for p in pc.default_policies(
        goodput_floor=0.3, k_consecutive=3)] == [p.row() for p in
                                                 jc.default_policies(
            goodput_floor=0.3, k_consecutive=3)]
    assert pc.RETUNE_LADDER == jc.RETUNE_LADDER
    assert pc.OUTCOMES == jc.OUTCOMES
    assert pc.META_CONTROL_KEY == jc.META_CONTROL_KEY == "control"
    assert set(pc.__all__) == set(jc.__all__)
    st0 = pc.PolicyState()
    assert st0.consec == 0 and st0.cooldown_left == 0
    monkeypatch.setenv("APEX_TPU_CONTROL", "0")
    assert pc.ControlConfig().enabled is False
    off = pc.RunController(pc.ControlConfig())
    assert off.on_window(step=0, signals={"goodput_fraction": 0.0}) == []
    assert off.windows == 0
    monkeypatch.setenv("APEX_TPU_CONTROL", "1")
    assert pc.ControlConfig().enabled is True
    assert pc.ControlConfig(enabled=False).enabled is False
    with pytest.raises(ValueError):
        pc.ControlConfig(max_actions=-1)


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.lists(st.one_of(
    st.floats(0.5, 5.0), st.just(float("nan")), st.just(float("inf")),
    st.none()), max_size=4), max_size=8))
def test_loss_window_signals_match_jax(windows):
    gauges = {}
    for name, pkg, Reg, Sink in (("jax", jc, JRegistry, JMemorySink),
                                 ("port", pc, Registry, MemorySink)):
        reg = Reg(sink=Sink(), flush_interval=0, rank0_only=False)
        ctl = pkg.RunController(pkg.ControlConfig(enabled=True),
                                registry=reg)
        for w, losses in enumerate(windows):
            ctl.on_window(step=2 * w, losses=losses)
        gauges[name] = ([(r["name"], r["value"]) for r in reg.flush()
                         if r.get("kind") == "metric"],
                        ctl._plateau_windows, ctl._loss_prev_mean)
        reg.close()
    assert gauges["port"] == gauges["jax"]


def test_straggler_streak_from_fed_rows_matches_jax():
    seen = {}
    for name, pkg in PKGS.items():
        calls = []
        ctl = pkg.RunController(
            pkg.ControlConfig(enabled=True, max_actions=10),
            [pkg.Policy(name="sq", signal="straggler_windows",
                        band=pkg.Band(hi=1.5), action="quarantine",
                        k_consecutive=1, cooldown_windows=0)],
            actuators={"quarantine": _recording(calls)})
        trail = []
        for step, slow in enumerate(["d3", "d3", "d3", "d3", "d5", "d5",
                                     None, None]):
            devs = {f"d{i}": 1.0 for i in range(8)}
            if slow:
                devs[slow] = 8.0
                ctl.feed_device_stats(step, devs)
            if step % 2:
                ctl.on_window(step=step)
                trail.append((ctl._named_device, ctl._streak))
        seen[name] = (trail, calls)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == [3]


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def _doc(pkg):
    pols = [p.row() for p in pkg.default_policies()]
    decs = [{"window": 2, "step": 4, "policy": "exposed_comm_ceiling",
             "signal": "exposed_comm_fraction", "value": 0.41,
             "lo": None, "hi": 0.25, "action": "comm_retune",
             "outcome": "acted", "detail": {"from": "fp32", "to": "bf16"}},
            {"window": 4, "step": 8, "policy": "exposed_comm_ceiling",
             "signal": "exposed_comm_fraction", "value": 0.31,
             "lo": None, "hi": 0.25, "action": "comm_retune",
             "outcome": "suppressed_cooldown", "detail": {}}]
    return pkg.build_doc(enabled=True, windows=6, max_actions=3,
                         policies=pols, decisions=decs, status="completed")


def _tampered(doc):
    out = {"counter": dict(doc, actions_fired=5),
           "bound": dict(doc, actions_fired=9, max_actions=3),
           "kind": dict(doc, kind="ledger"),
           "version": dict(doc, version=2),
           "enabled": dict(doc, enabled="yes"),
           "windows": dict(doc, windows=-1),
           "not_dict": [], "none": None}
    for key, row in (("outcome", {"outcome": "vibes"}),
                     ("policy", {"policy": "ghost"}),
                     ("step", {"step": -3}), ("value", {"value": "x"})):
        out[key] = dict(doc, decisions=[dict(doc["decisions"][0], **row)])
    out["band"] = dict(doc, policies=[dict(doc["policies"][0], lo=None,
                                           hi=None)])
    out["k"] = dict(doc, policies=[dict(doc["policies"][0],
                                        k_consecutive=0)])
    return out


def test_ledger_docs_and_auditor_match_jax():
    jd, pd = _doc(jc), _doc(pc)
    assert _no_ts(pd) == _no_ts(jd)
    assert pc.control_violations(pd) == [] == jc.control_violations(pd)
    assert pc.format_control(pd) == jc.format_control(jd)
    for name, bad in _tampered(pd).items():
        got = pc.control_violations(bad)
        assert got and got == jc.control_violations(bad), name


def test_each_auditor_accepts_the_others_artifact(tmp_path):
    ppath = pc.write_doc(_doc(pc), directory=str(tmp_path / "p"))
    jpath = jc.write_doc(_doc(jc), directory=str(tmp_path / "j"))
    assert os.path.basename(ppath) == pc.ARTIFACT_NAME == jc.ARTIFACT_NAME
    assert _no_ts(jc.load_artifact(ppath)) == _no_ts(pc.load_artifact(
        str(tmp_path / "p")))
    assert _no_ts(pc.load_artifact(jpath)) == _no_ts(jc.load_artifact(
        jpath))
    bad = dict(_doc(pc), actions_fired=5)
    for pkg in PKGS.values():
        with pytest.raises(ValueError):
            pkg.write_doc(bad, directory=str(tmp_path / "bad"))
    assert not os.path.exists(tmp_path / "bad" / "CONTROL.json")
    (tmp_path / "t.json").write_text(json.dumps(bad))
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="actions_fired"):
            pkg.load_artifact(str(tmp_path / "t.json"))


def test_ledger_cli_through_the_telemetry_command(tmp_path, capsys):
    path = pc.write_doc(_doc(pc), directory=str(tmp_path))
    assert preport.main(["control", path]) == 0
    out = capsys.readouterr().out
    assert "control ledger" in out and "acted" in out
    assert out.strip() == pc.format_control(pc.load_artifact(path))
    assert pledger.cli([str(tmp_path)]) == 0
    capsys.readouterr()
    (tmp_path / "junk.json").write_text("{}")
    assert preport.main(["control", str(tmp_path / "junk.json")]) == 1
    assert "error" in capsys.readouterr().out


def test_report_folds_control_events():
    reg = Registry(sink=MemorySink(), flush_interval=0, rank0_only=False)
    reg.event("control.decision", step=4, policy="p", action="a",
              outcome="acted")
    reg.event("control.suppressed", step=6, policy="p",
              outcome="suppressed_cooldown")
    reg.event("control.action_failed", step=8, policy="p", error="e")
    s = preport.summarize(reg.flush())
    assert (s["control_actions"], s["control_suppressed"],
            s["control_failed"]) == (1, 1, 1)
    assert "actions 1" in preport.format_summary(s)


# ---------------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------------

def test_retune_ladder_walks_like_jax():
    walks = {}
    for name, pkg, coll in (("jax", jc, jcoll), ("port", pc, pcoll)):
        pol = pkg.Policy(name="comm", signal="exposed_comm_fraction",
                         band=pkg.Band(hi=0.25), action="comm_retune",
                         k_consecutive=1, cooldown_windows=0)
        ctl = pkg.RunController(pkg.ControlConfig(enabled=True,
                                                  max_actions=20), [pol])
        walk = []
        for w in range(8):
            rows = ctl.on_window(step=w,
                                 signals={"exposed_comm_fraction": 0.6})
            spec = coll.get_live_spec()
            walk.append((rows[0]["outcome"], rows[0]["detail"],
                         spec.scheme, spec.min_bytes))
        walks[name] = walk
        assert coll.resolve(None).scheme == "int8_blockscale"
        assert coll.resolve("fp32").scheme == "fp32"   # explicit wins
        coll.set_live_spec(None)
    assert walks["port"] == walks["jax"]
    base = pcoll.CollectiveSpec().min_bytes
    assert [w[2] for w in walks["port"][:3]] == ["bf16", "int8_blockscale",
                                                 "int8_blockscale"]
    assert walks["port"][2][3] == base // 2
    assert walks["port"][-1][0] == "failed_reverted"   # the floor


def test_failed_action_reverts_the_live_spec():
    class BadManager:
        def update_meta(self, patch):
            raise OSError("disk full")

    reg = Registry(sink=MemorySink(), flush_interval=0, rank0_only=False)
    pol = pc.Policy(name="comm", signal="exposed_comm_fraction",
                    band=pc.Band(hi=0.25), action="comm_retune",
                    k_consecutive=1, cooldown_windows=0)
    ctl = pc.RunController(pc.ControlConfig(enabled=True, max_actions=10),
                           [pol], registry=reg)
    ctl.arm(manager=BadManager())
    before = pcoll.get_live_spec()
    rows = ctl.on_window(step=3, signals={"exposed_comm_fraction": 0.6})
    assert rows[0]["outcome"] == "failed_reverted"
    assert "disk full" in rows[0]["detail"]["error"]
    assert pcoll.get_live_spec() == before and ctl.actions_fired == 0
    names = [r["name"] for r in reg.flush() if r.get("kind") == "event"]
    assert "control.action_failed" in names
    assert ctl.snapshot()["failed_reverted"] == 1


@pytest.mark.parametrize("policy,signal,value,needle", [
    ("replan_reshard", "goodput_fraction", 0.1, "profile"),
    ("quarantine", "straggler_windows", 3.0, "straggler"),
])
def test_actuators_without_context_degrade_as_jax(policy, signal, value,
                                                  needle):
    rows = {}
    for name, pkg in PKGS.items():
        band = pkg.Band(lo=0.5) if policy == "replan_reshard" \
            else pkg.Band(hi=1.5)
        ctl = pkg.RunController(
            pkg.ControlConfig(enabled=True, max_actions=3),
            [pkg.Policy(name="p", signal=signal, band=band, action=policy,
                        k_consecutive=1, cooldown_windows=0)])
        rows[name] = ctl.on_window(step=0, signals={signal: value})
    assert rows["port"][0]["outcome"] == "failed_reverted"
    assert needle in rows["port"][0]["detail"]["error"]
    assert rows["port"][0]["detail"] == rows["jax"][0]["detail"]


def test_control_source_makes_no_host_read():
    """No device read can hide in the package: no torch import and no
    ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()``, and every
    ``float(...)`` takes a host number (a loss the guard already read, a
    ledger field, a signal)."""
    d = os.path.join(ROOT, "apex_tpu_torch", "control")
    files = sorted(f for f in os.listdir(d) if f.endswith(".py"))
    assert files == ["__init__.py", "controller.py", "ledger.py",
                     "policy.py"]
    for f in files:
        src = open(os.path.join(d, f)).read()
        for pat in (r"\.item\(", r"\.cpu\(", r"\.tolist\(", r"\.numpy\(",
                    r"^\s*(import|from)\s+torch", r"synchronize\("):
            assert not re.search(pat, src, re.M), (f, pat)
        for arg in re.findall(r"float\(([^()]*(?:\([^()]*\))?[^()]*)\)",
                              src):
            assert not re.search(r"tensor|Tensor|\.to\(|device", arg), \
                (f, arg)


# ---------------------------------------------------------------------------
# with the guard
# ---------------------------------------------------------------------------

def _sgd_step(w, batch):
    return w - 0.1 * 2 * (w - batch), ((w - batch) ** 2).sum()


def _batch_at(i):
    return torch.from_numpy(
        np.random.RandomState(i).randn(4).astype(np.float32))


def _jax_sgd_step():
    @jax.jit
    def step(w, batch):
        g = jax.grad(lambda w: jnp.sum((w - batch) ** 2))(w)
        return w - 0.1 * g, jnp.sum((w - batch) ** 2)
    return step


def _jax_batch_at(i):
    return jnp.asarray(np.random.RandomState(i).randn(4).astype(np.float32))


@pytest.fixture
def count_cpu(monkeypatch):
    """Every ``Tensor.cpu()`` of the process: the guard's reads."""
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append(1)
                        or real(self, *a, **k))
    return calls


def test_disabled_controller_is_a_bitwise_noop(tmp_path, count_cpu):
    def run(controller, d):
        cfg = GuardConfig(ckpt_dir=str(d), save_every_steps=5,
                          check_every=5, backoff_seconds=0.01,
                          enabled=True)
        g = TrainGuard(_sgd_step, cfg, controller=controller)
        w, rep = g.run(torch.zeros(4), _batch_at, 20)
        return w, rep, g
    w_none, r_none, g_none = run(None, tmp_path / "a")
    n_none = len(count_cpu)
    count_cpu.clear()
    ctl = pc.RunController(pc.ControlConfig(enabled=False))
    w_off, r_off, g_off = run(ctl, tmp_path / "b")
    assert torch.equal(w_none, w_off)
    assert len(count_cpu) == n_none and g_off.host_reads == g_none.host_reads
    assert r_off.control is None and r_off.control_path is None
    assert ctl.windows == 0
    assert not os.path.exists(tmp_path / "b" / pc.ARTIFACT_NAME)


def test_enabled_controller_adds_no_read(tmp_path, count_cpu):
    ctl = pc.RunController(pc.ControlConfig(enabled=True))
    g = TrainGuard(_sgd_step, GuardConfig(check_every=10, enabled=True),
                   controller=ctl)
    _, rep = g.run(torch.zeros(4), _batch_at, 20)
    assert rep.status == "completed"
    assert len(count_cpu) == g.host_reads == g.health_checks == 2
    assert ctl.windows == 2 and rep.control["decisions"] == []
    assert pc.control_violations(rep.control) == []
    count_cpu.clear()
    ctl2 = pc.RunController(pc.ControlConfig(enabled=True))
    g2 = TrainGuard(_sgd_step, GuardConfig(
        ckpt_dir=str(tmp_path), save_every_steps=4, check_every=2,
        backoff_seconds=0.01, enabled=True, world_size=8),
        controller=ctl2)
    _, rep2 = g2.run(torch.zeros(4), _batch_at, 20)
    assert len(count_cpu) == g2.host_reads == \
        g2.health_checks + rep2.checkpoints
    doc = pc.load_artifact(rep2.control_path)
    assert doc["status"] == "completed" and doc["windows"] == 10


def test_ranks_decide_on_rank0_signals(tmp_path):
    """World 2 on gloo, the ranks' goodput differing: the rank that stalls
    on its batches sees a low goodput, the other (waiting inside the
    step's all-reduce) a high one.  Every window the ranks take rank 0's
    signals, so they take the same decisions and end on the same wire
    spec: both retune when rank 0 stalls, neither when rank 1 does.  Only
    rank 0 writes CONTROL.json; the syncs are counted, the reads are
    the health checks'."""
    out = _torch_dist.run_ranks(_torch_dist.control_sync_cases, 2,
                                tmp_path, str(tmp_path), [0, 1])
    for case, stall in enumerate((0, 1)):
        r0, r1 = out[0][case], out[1][case]
        assert r0["decisions"] == r1["decisions"]
        assert r0["live"] == r1["live"]
        acted = [d for d in r0["decisions"] if d["outcome"] == "acted"]
        if stall == 0:
            assert len(acted) == 1 and r0["live"] == "bf16"
            assert acted[0]["action"] == "comm_retune"
        else:
            assert acted == [] and r0["live"] is None
        for r in (r0, r1):
            assert r["windows"] == r["syncs"] == 4
            assert r["reads"] == (4, 4)
        assert r0["control_path"] is not None and r1["control_path"] is None
        assert pc.control_violations(pc.load_artifact(r0["control_path"])) \
            == []


def _decisions(doc):
    return [(d["step"], d["policy"], d["action"], d["outcome"])
            for d in doc["decisions"]]


def test_chaos_goodput_degrade_fires_replan_reshard(tmp_path):
    docs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        if name == "jax":
            tr = jtrace.Tracer(enabled=True, flight_dir=str(d))
            prev = jtrace.set_tracer(tr)
            ctl = jc.RunController(jc.ControlConfig(
                enabled=True, max_actions=1,
                profile=jplan.ModelProfile(**TINY_PROFILE)))
            cfg = JGuardConfig(ckpt_dir=str(d / "ck"), save_every_steps=2,
                               check_every=2, backoff_seconds=0.01,
                               enabled=True, world_size=8)
            try:
                _, rep = JTrainGuard(
                    _jax_sgd_step(), cfg,
                    plan=jfaults.parse("goodput_degrade@2x20:0.02"),
                    controller=ctl).run(jnp.zeros(4), _jax_batch_at, 10)
            finally:
                jtrace.set_tracer(prev)
            meta = JManager(str(d / "ck")).load_latest(with_meta=True)[2]
        else:
            tr = trace.Tracer(enabled=True, flight_dir=str(d))
            prev = trace.set_tracer(tr)
            ctl = pc.RunController(pc.ControlConfig(
                enabled=True, max_actions=1,
                profile=pplan.ModelProfile(**TINY_PROFILE)))
            cfg = GuardConfig(ckpt_dir=str(d / "ck"), save_every_steps=2,
                              check_every=2, backoff_seconds=0.01,
                              enabled=True, world_size=8)
            try:
                _, rep = TrainGuard(
                    _sgd_step, cfg,
                    plan=faults.parse("goodput_degrade@2x20:0.02"),
                    controller=ctl).run(torch.zeros(4), _batch_at, 10)
            finally:
                trace.set_tracer(prev)
            meta = CheckpointManager(str(d / "ck")).load_latest(
                with_meta=True)[2]
        assert rep.status == "completed"
        assert jc.control_violations(rep.control) == [] == \
            pc.control_violations(rep.control)
        docs[name] = (rep.control, rep.goodput, meta)
    assert _decisions(docs["port"][0]) == _decisions(docs["jax"][0])
    doc, gdoc, meta = docs["port"]
    acted = [d for d in doc["decisions"] if d["outcome"] == "acted"]
    assert len(acted) == 1 and acted[0]["action"] == "replan_reshard"
    assert acted[0]["value"] < 0.5 and acted[0]["detail"]["chips"] == 8
    assert acted[0]["detail"] == docs["jax"][0]["decisions"][
        [d["outcome"] for d in docs["jax"][0]["decisions"]].index(
            "acted")]["detail"]
    assert meta["control"]["plan"] == docs["jax"][2]["control"]["plan"]
    assert isinstance(meta["plan"], dict)
    assert gdoc["classes"]["reshard"]["ms"] > 0.0
    assert gdoc["classes"]["idle"]["ms"] > 0.0


def test_chaos_straggler_quarantines_via_elastic_resize(tmp_path):
    docs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        if name == "jax":
            reg = JRegistry(sink=JMemorySink(), flush_interval=0,
                            rank0_only=False)
            ctl = jc.RunController(jc.ControlConfig(enabled=True,
                                                    max_actions=2),
                                   registry=reg)
            cfg = JGuardConfig(ckpt_dir=str(d), save_every_steps=2,
                               check_every=2, backoff_seconds=0.01,
                               enabled=True, world_size=8)
            _, rep = JTrainGuard(
                _jax_sgd_step(), cfg, plan=jfaults.parse(
                    "straggler@2x40:4.0"), registry=reg,
                controller=ctl).run(jnp.zeros(4), _jax_batch_at, 30)
            meta = JManager(str(d)).load_latest(with_meta=True)[2]
        else:
            reg = Registry(sink=MemorySink(), flush_interval=0,
                           rank0_only=False)
            ctl = pc.RunController(pc.ControlConfig(enabled=True,
                                                    max_actions=2),
                                   registry=reg)
            cfg = GuardConfig(ckpt_dir=str(d), save_every_steps=2,
                              check_every=2, backoff_seconds=0.01,
                              enabled=True, world_size=8)
            _, rep = TrainGuard(
                _sgd_step, cfg, plan=faults.parse("straggler@2x40:4.0"),
                registry=reg, controller=ctl).run(torch.zeros(4),
                                                  _batch_at, 30)
            meta = CheckpointManager(str(d)).load_latest(with_meta=True)[2]
        names = [r["name"] for r in reg.flush() if r.get("kind") == "event"]
        docs[name] = (rep, meta, names)
    rep, meta, names = docs["port"]
    jrep = docs["jax"][0]
    assert (rep.status, rep.resize_to, rep.final_step) == \
        (jrep.status, jrep.resize_to, jrep.final_step) == \
        ("preempted", 7, jrep.final_step)
    assert _decisions(rep.control) == _decisions(jrep.control)
    q = [d for d in rep.control["decisions"] if d["outcome"] == "acted"]
    assert len(q) == 1 and q[0]["detail"] == {
        "device": "d0", "from_world": 8, "to_world": 7}
    assert meta["control"] == docs["jax"][1]["control"]
    assert "control.resize_requested" in names
    assert "control.decision" in names
    assert pc.control_violations(rep.control) == []


def test_chaos_midaction_preempt_resumes_with_acted_config(tmp_path):
    pol = pc.Policy(name="gp_probe", signal="goodput_fraction",
                    band=pc.Band(lo=2.0), action="comm_retune",
                    k_consecutive=1, cooldown_windows=0)
    tr = trace.Tracer(enabled=True, flight_dir=str(tmp_path))
    prev = trace.set_tracer(tr)
    try:
        cfg = lambda: GuardConfig(                          # noqa: E731
            ckpt_dir=str(tmp_path / "ck"), save_every_steps=2,
            check_every=2, backoff_seconds=0.01, enabled=True)
        ctl1 = pc.RunController(pc.ControlConfig(enabled=True,
                                                 max_actions=1), [pol])
        _, r1 = TrainGuard(_sgd_step, cfg(), plan=faults.parse("preempt@5"),
                           controller=ctl1).run(torch.zeros(4), _batch_at,
                                                20)
        assert r1.status == "preempted" and ctl1.actions_fired == 1
        assert pcoll.get_live_spec().scheme == "bf16"
        meta = CheckpointManager(str(tmp_path / "ck")).load_latest(
            with_meta=True)[2]
        assert meta["control"]["live_collective"].startswith("bf16")
        # a new process: the live override is gone until arm() restores it
        pcoll.set_live_spec(None)
        reg = Registry(sink=MemorySink(), flush_interval=0,
                       rank0_only=False)
        ctl2 = pc.RunController(pc.ControlConfig(enabled=True,
                                                 max_actions=0), [pol],
                                registry=reg)
        _, r2 = TrainGuard(_sgd_step, cfg(), controller=ctl2).run(
            torch.zeros(4), _batch_at, 20)
    finally:
        trace.set_tracer(prev)
    assert r2.status == "completed" and r2.resumed_from == 5
    assert pcoll.get_live_spec().scheme == "bf16"
    rearmed = [r for r in reg.flush() if r.get("kind") == "event"
               and r["name"] == "control.rearmed"]
    assert len(rearmed) == 1
    assert rearmed[0]["fields"]["live_collective"].startswith("bf16")
    meta2 = CheckpointManager(str(tmp_path / "ck")).load_latest(
        with_meta=True)[2]
    assert meta2["control"]["live_collective"].startswith("bf16")
    # the JAX auditor accepts the resumed run's ledger
    assert jc.control_violations(r2.control) == []
