"""The port's ``TrainGuard`` against the JAX package's.

The guard cases of ``tests/L0/test_resilience.py`` (preempt -> bitwise
resume, a real SIGTERM, nan -> rollback, the retry budget exhausted, a
non-seekable source, scaler-floor escalation, a disabled guard, the
``APEX_TPU_GUARD`` switch, batched host reads, a tuple carry,
``on_check``, the ``resumed`` event) and of ``tests/L0/
test_data_sharded.py`` (the data cursor of a sharded source, a changed
dataset) run twice from the same numpy seeds: with the JAX guard over the
JAX step, and with the port's guard over its torch twin.  The
``GuardReport`` fields, the sequence of event names and the steps of each
manifest's checkpoints must be equal; the final parameters agree within
1e-6 across the packages, and within each package a chaos run ends
bitwise on its clean run.

Port-only: the guard leaves the process as it found it (signal handlers,
the goodput ledger and the tracer's hook, the fault plan, no writer
thread) after a normal run, a preemption, an abort and an OOM; its host
reads are its health checks plus its snapshots; the JAX package's
``CheckpointManager`` reads the port guard's manifest and verifies its
files; a generator carried in the state resumes bit for bit; a narrow
ResNet-18 under amp O2 runs the imagenet ``--auto-resume`` entry
(``train.resnet_guarded_run``) through a preemption and a resume, bit for
bit, on each of its three batch sources' contracts.
"""
import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import checkpoint as jckpt
from apex_tpu.resilience import GuardAbort as JGuardAbort
from apex_tpu.resilience import GuardConfig as JGuardConfig
from apex_tpu.resilience import TrainGuard as JTrainGuard
from apex_tpu.resilience import ckpt as jck
from apex_tpu.resilience import faults as jfaults
from apex_tpu.telemetry import MemorySink as JMemorySink
from apex_tpu.telemetry import Registry as JRegistry

from apex_tpu_torch import amp
from apex_tpu_torch.resilience import (CheckpointManager, GuardAbort,
                                       GuardConfig, TrainGuard, faults)
from apex_tpu_torch.resilience import guard as pguard
from apex_tpu_torch.telemetry import MemorySink, Registry
from apex_tpu_torch.train import (resnet_guard_batches,
                                  resnet_synthetic_batch_at)

from _torch_port import amp_uninit  # noqa: F401


@pytest.fixture(autouse=True)
def _no_installed_plan():
    prev, jprev = faults.install(None), jfaults.install(None)
    yield
    faults.install(prev)
    jfaults.install(jprev)


def _batch_np(i):
    return np.random.RandomState(i).randn(4).astype(np.float32)


class _Jax:
    """The JAX package's side of each case."""
    Guard, Config, Abort, faults = JTrainGuard, JGuardConfig, JGuardAbort, \
        jfaults

    @staticmethod
    def zeros(n):
        return jnp.zeros(n)

    @staticmethod
    def ones(n):
        return jnp.ones(n)

    @staticmethod
    def batch_at(i):
        return jnp.asarray(_batch_np(i))

    @staticmethod
    def sgd_step():
        @jax.jit
        def step(w, batch):
            g = jax.grad(lambda w: jnp.sum((w - batch) ** 2))(w)
            finite = jnp.all(jnp.isfinite(g))
            w2 = jnp.where(finite, w - 0.1 * g, w)
            return w2, jnp.sum((w - batch) ** 2)
        return step

    @staticmethod
    def add_step(w, b):
        return w + b, jnp.sum(w)

    @staticmethod
    def nan_step(w, batch):
        return w, jnp.asarray(float("nan"))

    @staticmethod
    def carry_step(carry, batch):
        a, b = carry
        return (a + batch, b - batch)

    @staticmethod
    def registry():
        return JRegistry(sink=JMemorySink(), flush_interval=0,
                         rank0_only=False)

    @staticmethod
    def np(x):
        return np.asarray(x)


class _Port:
    """The port's side: the same step in torch fp32 on the CPU."""
    Guard, Config, Abort, faults = TrainGuard, GuardConfig, GuardAbort, \
        faults

    @staticmethod
    def zeros(n):
        return torch.zeros(n)

    @staticmethod
    def ones(n):
        return torch.ones(n)

    @staticmethod
    def batch_at(i):
        return torch.from_numpy(_batch_np(i))

    @staticmethod
    def sgd_step():
        def step(w, batch):
            g = 2.0 * (w - batch)
            finite = torch.isfinite(g).all()
            w2 = torch.where(finite, w - 0.1 * g, w)
            return w2, ((w - batch) ** 2).sum()
        return step

    @staticmethod
    def add_step(w, b):
        return w + b, w.sum()

    @staticmethod
    def nan_step(w, batch):
        return w, torch.tensor(float("nan"))

    @staticmethod
    def carry_step(carry, batch):
        a, b = carry
        return (a + batch, b - batch)

    @staticmethod
    def registry():
        return Registry(sink=MemorySink(), flush_interval=0,
                        rank0_only=False)

    @staticmethod
    def np(x):
        return x.detach().numpy()


FRAMEWORKS = (_Jax, _Port)


def _cfg(fw, path, **kw):
    base = dict(ckpt_dir=str(path), save_every_steps=5, check_every=5,
                backoff_seconds=0.01, enabled=True)
    base.update(kw)
    return fw.Config(**base)


def _events(reg):
    return [r["name"] for r in reg.flush() if r.get("kind") == "event"]


def _manifest_steps(path):
    with open(os.path.join(str(path), "MANIFEST.json")) as f:
        return [r["step"] for r in json.load(f)["checkpoints"]]


def _report(rep):
    return dataclasses.asdict(rep)


def _both(tmp_path, case):
    """``case(fw, directory)`` for each package, in its own directory:
    the two records."""
    return [case(fw, tmp_path / fw.__name__) for fw in FRAMEWORKS]


def _same_record(jrec, prec, final_keys=("final",)):
    for key in jrec:
        if key in final_keys:
            np.testing.assert_allclose(prec[key], jrec[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        else:
            assert prec[key] == jrec[key], key


# ---------------------------------------------------------------------------
# the chaos proofs
# ---------------------------------------------------------------------------

def test_preempt_resume_bitwise_like_jax(tmp_path):
    def case(fw, d):
        reg = fw.registry()
        ref, rep0 = fw.Guard(fw.sgd_step(), _cfg(fw, d / "ref")).run(
            fw.zeros(4), fw.batch_at, 20)
        plan = fw.faults.parse("preempt@7")
        _, r1 = fw.Guard(fw.sgd_step(), _cfg(fw, d / "chaos"), plan=plan,
                         registry=reg).run(fw.zeros(4), fw.batch_at, 20)
        m1 = _manifest_steps(d / "chaos")
        w2, r2 = fw.Guard(fw.sgd_step(), _cfg(fw, d / "chaos"), plan=plan,
                          registry=reg).run(fw.zeros(4), fw.batch_at, 20)
        assert np.array_equal(fw.np(w2), fw.np(ref))          # bitwise
        return dict(reports=[_report(r) for r in (rep0, r1, r2)],
                    events=_events(reg),
                    manifests=[m1, _manifest_steps(d / "chaos"),
                               _manifest_steps(d / "ref")],
                    final=fw.np(w2))
    jrec, prec = _both(tmp_path, case)
    assert prec["reports"][1]["status"] == "preempted"
    assert prec["reports"][1]["final_step"] == 7
    assert prec["reports"][2]["resumed_from"] == 7
    _same_record(jrec, prec)


def test_real_sigterm_snapshots_and_resumes_like_jax(tmp_path):
    before = signal.getsignal(signal.SIGTERM)

    def case(fw, d):
        calls = {"n": 0}

        def step(w, batch):
            calls["n"] += 1
            if calls["n"] == 4:
                signal.raise_signal(signal.SIGTERM)   # delivered mid-run
            return fw.add_step(w, batch)
        w, r1 = fw.Guard(step, _cfg(fw, d)).run(
            fw.zeros(2), lambda i: fw.ones(2), 10)
        assert signal.getsignal(signal.SIGTERM) is before
        w, r2 = fw.Guard(step, _cfg(fw, d)).run(
            fw.zeros(2), lambda i: fw.ones(2), 10)
        return dict(reports=[_report(r1), _report(r2)],
                    manifests=[_manifest_steps(d)], final=fw.np(w))
    jrec, prec = _both(tmp_path, case)
    assert prec["reports"][0]["status"] == "preempted"
    assert prec["reports"][0]["final_step"] == 4
    assert prec["final"][0] == 10.0
    _same_record(jrec, prec)


def test_nan_injection_recovers_via_rollback_like_jax(tmp_path):
    def case(fw, d):
        reg = fw.registry()
        w, rep = fw.Guard(fw.sgd_step(), _cfg(fw, d / "a",
                                              nonfinite_streak=3),
                          plan=fw.faults.parse("nan@6x4"),
                          registry=reg).run(fw.zeros(4), fw.batch_at, 20)
        ref, _ = fw.Guard(fw.sgd_step(), _cfg(fw, d / "b")).run(
            fw.zeros(4), fw.batch_at, 20)
        assert np.array_equal(fw.np(w), fw.np(ref))           # bitwise
        return dict(reports=[_report(rep)], events=_events(reg),
                    manifests=[_manifest_steps(d / "a")], final=fw.np(w))
    jrec, prec = _both(tmp_path, case)
    assert prec["reports"][0]["rollbacks"] == 1
    assert prec["reports"][0]["faults_injected"] == 4
    assert prec["events"].count("fault_injected") == 4
    assert "rollback" in prec["events"]
    _same_record(jrec, prec)


def test_rollback_budget_exhausted_aborts_like_jax(tmp_path):
    def case(fw, d):
        reg = fw.registry()
        g = fw.Guard(fw.nan_step, _cfg(fw, d, max_retries=2,
                                       nonfinite_streak=3), registry=reg)
        with pytest.raises(fw.Abort, match="budget exhausted"):
            g.run(fw.zeros(2), fw.batch_at, 50)
        return dict(events=_events(reg), manifests=[_manifest_steps(d)])
    jrec, prec = _both(tmp_path, case)
    assert prec["events"].count("rollback") == 2
    _same_record(jrec, prec)


def test_rollback_needs_seekable_source_like_jax(tmp_path):
    def case(fw, d):
        reg = fw.registry()
        g = fw.Guard(fw.sgd_step(), _cfg(fw, d, nonfinite_streak=3),
                     plan=fw.faults.parse("nan@2x6"), registry=reg)
        with pytest.raises(fw.Abort, match="batches.step."):
            g.run(fw.zeros(4), iter([fw.batch_at(i) for i in range(20)]),
                  20)
        return dict(events=_events(reg), manifests=[_manifest_steps(d)])
    jrec, prec = _both(tmp_path, case)
    _same_record(jrec, prec)


def test_scaler_floor_escalation_like_jax(tmp_path):
    """inf injection collapses the dynamic loss scale to its floor; the
    ``floor_pinned`` checks escalate to one rollback whose restored
    (pre-collapse) scale clears the detector.  The same amp O2 +
    FusedSGD step in both packages (fp16 model, fp32 masters)."""
    from apex_tpu import amp as jamp
    from apex_tpu.amp import scaler as jscaler
    from apex_tpu.optimizers import FusedSGD as JFusedSGD
    from apex_tpu_torch.amp import scaler as pscaler
    from apex_tpu_torch.optimizers import FusedSGD

    def jax_start():
        st = jamp.initialize({"w": jnp.ones(4)}, JFusedSGD(lr=0.01),
                             opt_level="O2", verbosity=0)
        st = st._replace(scalers=(jscaler.init(
            "dynamic", init_scale=4.0, min_loss_scale=2.0),))

        @jax.jit
        def step(state, batch):
            def loss_fn(p):
                pred = jnp.sum(p["w"].astype(jnp.float32) * batch)
                loss = (pred - 1.0) ** 2
                return jamp.scale_loss(loss, state), loss
            g, loss = jax.grad(loss_fn, has_aux=True)(state.model_params)
            return jamp.amp_step(state, g), loss
        return st, step, lambda s: np.asarray(s.params_for_eval()["w"]), \
            lambda s: float(s.scalers[0].loss_scale)

    def port_start():
        st = amp.initialize({"w": torch.ones(4)}, FusedSGD(lr=0.01),
                            opt_level="O2", verbosity=0)
        st = st._replace(scalers=(pscaler.init(
            "dynamic", init_scale=4.0, min_loss_scale=2.0, device="cpu"),))

        def step(state, batch):
            w = state.model_params["w"].detach().requires_grad_(True)
            pred = (w.float() * batch).sum()
            loss = (pred - 1.0) ** 2
            (g,) = torch.autograd.grad(amp.scale_loss(loss, state), [w])
            return amp.amp_step(state, {"w": g}), loss.detach()
        return st, step, \
            lambda s: s.params_for_eval()["w"].detach().numpy(), \
            lambda s: float(s.scalers[0].loss_scale)

    def case(fw, d):
        st0, step, params, scale = (jax_start if fw is _Jax
                                    else port_start)()
        reg = fw.registry()
        g = fw.Guard(step, _cfg(fw, d, save_every_steps=0, floor_patience=2,
                                nonfinite_streak=100),
                     plan=fw.faults.parse("inf@2x6"), registry=reg)
        st, rep = g.run(st0, fw.batch_at, 15)
        assert scale(st) > 2.0
        recs = [r for r in reg.flush() if r.get("kind") == "event"]
        rb = [r for r in recs if r["name"] == "rollback"]
        assert rb and rb[0]["fields"]["reason"] == \
            "loss scale pinned at floor"
        return dict(reports=[_report(rep)], events=[r["name"] for r in recs],
                    manifests=[_manifest_steps(d)], final=params(st))
    jrec, prec = _both(tmp_path, case)
    assert prec["reports"][0]["rollbacks"] == 1
    _same_record(jrec, prec)


def test_disabled_guard_is_a_true_noop(monkeypatch, tmp_path):
    """No host read (no ``.cpu()`` nor ``device_get``), no thread, no
    signal handler, no checkpoint directory, in either package."""
    syncs, cpus = [], []
    monkeypatch.setattr(jax, "device_get",
                        lambda x: syncs.append("get") or x)
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: cpus.append(1)
                        or real_cpu(self, *a, **k))
    before_term = signal.getsignal(signal.SIGTERM)

    def case(fw, d):
        step = fw.sgd_step()
        seen = []

        def spy_step(w, batch):
            seen.append((signal.getsignal(signal.SIGTERM) is before_term,
                         threading.active_count()))
            return step(w, batch)
        n_threads = threading.active_count()
        g = fw.Guard(spy_step, fw.Config(ckpt_dir=str(d), enabled=False,
                                         save_every_steps=1))
        w, rep = g.run(fw.zeros(4), fw.batch_at, 4)
        assert all(h and n == n_threads for h, n in seen)
        assert not d.exists() and g.manager is None
        return dict(reports=[_report(rep)], final=fw.np(w))
    jrec, prec = _both(tmp_path, case)
    assert syncs == [] and cpus == []
    assert prec["reports"][0]["status"] == "disabled"
    _same_record(jrec, prec)


def test_guard_env_var_disables(monkeypatch):
    for value, want in (("off", False), ("1", True), ("no", False)):
        monkeypatch.setenv("APEX_TPU_GUARD", value)
        assert GuardConfig().enabled is JGuardConfig().enabled is want
    monkeypatch.setenv("APEX_TPU_GUARD", "no")
    assert GuardConfig(enabled=True).enabled is True   # explicit wins


def test_enabled_guard_batches_host_reads(monkeypatch):
    """20 steps at check_every 10 and no checkpoint directory: two batched
    reads in both packages (``device_get`` / ``.cpu()``), none a step."""
    gets, cpus = [], []
    real_get, real_cpu = jax.device_get, torch.Tensor.cpu
    monkeypatch.setattr(jax, "device_get",
                        lambda x: gets.append(1) or real_get(x))
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: cpus.append(1)
                        or real_cpu(self, *a, **k))
    reps = []
    for fw in FRAMEWORKS:
        g = fw.Guard(fw.sgd_step(), fw.Config(check_every=10, enabled=True))
        _, rep = g.run(fw.zeros(4), fw.batch_at, 20)
        reps.append(_report(rep))
    assert len(gets) == len(cpus) == 2
    assert g.host_reads == g.health_checks == 2
    assert reps[0] == reps[1]


def test_state_only_step_fn_with_tuple_carry_like_jax(tmp_path):
    def case(fw, d):
        g = fw.Guard(fw.carry_step, _cfg(fw, d, save_every_steps=4,
                                         check_every=4))
        (a, b), r1 = g.run((fw.zeros(2), fw.zeros(2)),
                           lambda i: fw.ones(2), 10)
        assert fw.np(a)[0] == 10.0 and fw.np(b)[0] == -10.0
        (a, b), r2 = g.run((fw.zeros(2), fw.zeros(2)),
                           lambda i: fw.ones(2), 12)
        assert fw.np(a)[0] == 12.0
        return dict(reports=[_report(r1), _report(r2)],
                    manifests=[_manifest_steps(d)],
                    final=np.concatenate([fw.np(a), fw.np(b)]))
    jrec, prec = _both(tmp_path, case)
    assert prec["reports"][0]["checkpoints"] == 4   # anchor, 4, 8, exit
    assert prec["reports"][1]["resumed_from"] == 10
    _same_record(jrec, prec)


def test_on_check_reports_resolved_losses_like_jax(tmp_path):
    def case(fw, d):
        seen = []
        fw.Guard(fw.sgd_step(), _cfg(fw, d, check_every=5),
                 on_check=lambda step, losses: seen.append(
                     (step, [float(x) for x in losses]))).run(
            fw.zeros(4), fw.batch_at, 10)
        assert all(type(s) is int for s, _ in seen)
        return dict(steps=[s for s, _ in seen],
                    final=np.asarray([x for _, xs in seen for x in xs]))
    jrec, prec = _both(tmp_path, case)
    assert prec["steps"] == [5, 10]
    _same_record(jrec, prec)


def test_telemetry_resumed_event_like_jax(tmp_path):
    def case(fw, d):
        plan = fw.faults.parse("preempt@3")
        fw.Guard(fw.sgd_step(), _cfg(fw, d), plan=plan).run(
            fw.zeros(4), fw.batch_at, 8)
        reg = fw.registry()
        _, rep = fw.Guard(fw.sgd_step(), _cfg(fw, d), plan=plan,
                          registry=reg).run(fw.zeros(4), fw.batch_at, 8)
        return dict(reports=[_report(rep)], events=_events(reg))
    jrec, prec = _both(tmp_path, case)
    assert prec["reports"][0]["resumed_from"] == 3
    assert "resumed" in prec["events"]
    _same_record(jrec, prec)


# ---------------------------------------------------------------------------
# the data cursor of a sharded source (tests/L0/test_data_sharded.py)
# ---------------------------------------------------------------------------

def _write_shards(d, sizes, shift=0.0):
    n = 0
    for i, sz in enumerate(sizes):
        np.savez(os.path.join(d, f"shard-{i:03d}.npz"),
                 x=(np.arange(n, n + sz, dtype=np.float32)[:, None]
                    * np.ones((1, 4), np.float32) + shift),
                 y=np.arange(n, n + sz, dtype=np.int32))
        n += sz


def _sharded(fw, d, steps):
    if fw is _Jax:
        from apex_tpu.data import ShardedDataset, ShardedLoader
        return ShardedLoader(ShardedDataset(str(d)), global_batch=8, seed=1,
                             num_steps=steps,
                             transform=lambda b, s: jnp.asarray(b["x"]))
    from apex_tpu_torch.data import ShardedDataset, ShardedLoader
    return ShardedLoader(ShardedDataset(str(d)), global_batch=8, seed=1,
                         num_steps=steps,
                         transform=lambda b, s: torch.from_numpy(b["x"]))


def _mean_step(fw):
    if fw is _Jax:
        @jax.jit
        def step(w, batch):
            g = jax.grad(lambda w: jnp.sum((w - jnp.mean(batch, 0)) ** 2))(w)
            return w - 0.1 * g, jnp.sum((w - jnp.mean(batch, 0)) ** 2)
        return step

    def tstep(w, batch):
        m = batch.mean(0)
        return w - 0.1 * (2.0 * (w - m)), ((w - m) ** 2).sum()
    return tstep


def test_preempt_on_sharded_data_records_the_cursor_like_jax(tmp_path):
    """preempt@7 mid-epoch on an ``.npz`` shard dataset: both manifests
    carry the same data block (index digest and the cursor at step 7), and
    the resumed runs end on their clean runs' bits."""
    from apex_tpu_torch.data import build_index
    data = tmp_path / "data"
    data.mkdir()
    _write_shards(str(data), [13, 14, 13])      # 40 records, 5 steps/epoch
    build_index(str(data))

    def case(fw, d):
        ld = _sharded(fw, data, 20)
        ref, _ = fw.Guard(_mean_step(fw), _cfg(fw, d / "ref")).run(
            fw.zeros(4), ld, 20)
        plan = fw.faults.parse("preempt@7")
        _, r1 = fw.Guard(_mean_step(fw), _cfg(fw, d / "ck"), plan=plan).run(
            fw.zeros(4), ld, 20)
        with open(os.path.join(str(d / "ck"), "MANIFEST.json")) as f:
            meta = json.load(f)["meta"]
        w2, r2 = fw.Guard(_mean_step(fw), _cfg(fw, d / "ck"),
                          plan=plan).run(fw.zeros(4), ld, 20)
        assert np.array_equal(fw.np(w2), fw.np(ref))
        return dict(reports=[_report(r1), _report(r2)], meta=meta,
                    final=fw.np(w2))
    jrec, prec = _both(tmp_path, case)
    cur = prec["meta"]["data"]["cursor"]
    assert cur["step"] == 7 and cur["epoch"] == 1 and cur["epoch_step"] == 2
    _same_record(jrec, prec)


def test_changed_dataset_raises_typed_mismatch(tmp_path):
    from apex_tpu_torch.data import build_index
    from apex_tpu_torch.resilience import DataStreamMismatchError
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    _write_shards(str(d1), [20, 20])
    _write_shards(str(d2), [20, 20], shift=1.0)
    build_index(str(d1)), build_index(str(d2))
    plan = faults.parse("preempt@6")
    _, r1 = TrainGuard(_mean_step(_Port), _cfg(_Port, tmp_path / "ck"),
                       plan=plan).run(torch.zeros(4),
                                      _sharded(_Port, d1, 16), 16)
    assert r1.status == "preempted"
    with pytest.raises(DataStreamMismatchError, match="dataset changed"):
        TrainGuard(_mean_step(_Port), _cfg(_Port, tmp_path / "ck"),
                   plan=plan).run(torch.zeros(4), _sharded(_Port, d2, 16),
                                  16)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _process_state():
    from apex_tpu_torch.telemetry import goodput, trace
    tr = trace.get_tracer()
    return dict(
        term=signal.getsignal(signal.SIGTERM),
        int=signal.getsignal(signal.SIGINT),
        ledger=goodput.get_ledger(),
        hook=getattr(tr, "ledger", None),
        plan=faults.active_plan(),
        writers=[t.name for t in threading.enumerate()
                 if t.name == "apex-tpu-torch-ckpt-writer"])


@pytest.mark.parametrize("ending", ["completed", "preempted", "abort",
                                    "oom", "error"])
def test_guard_leaves_the_process_as_it_found_it(ending, tmp_path):
    """With a tracer installed (so the guard installs its goodput ledger
    and hooks the tracer) and a fault plan installed: after a normal run,
    a preemption, a ``GuardAbort``, an injected OOM and a step that
    raises, the handlers, the installed ledger, the tracer's hook, the
    installed plan and the threads are what they were, and GOODPUT.json
    was written."""
    from apex_tpu_torch.telemetry import trace
    tr = trace.Tracer(enabled=True, flight_dir=str(tmp_path / "flight"))
    prev_tr = trace.set_tracer(tr)
    spec = {"completed": "nan@100", "preempted": "preempt@3",
            "abort": "nan@1x30", "oom": "oom@2", "error": "nan@100"}[ending]
    faults.install(faults.parse(spec))
    try:
        before = _process_state()
        step = _Port.sgd_step()
        if ending == "error":
            def step(w, b, _inner=step):
                if float(b[0]) != float(b[0]) or w.abs().sum() > 0:
                    raise ValueError("boom")
                return _inner(w, b)
        g = TrainGuard(step, _cfg(_Port, tmp_path / "ck", max_retries=1,
                                  nonfinite_streak=3))
        if ending in ("completed", "preempted"):
            _, rep = g.run(torch.zeros(4), _Port.batch_at, 10)
            assert rep.status == ending
        else:
            err = {"abort": GuardAbort, "oom": RuntimeError,
                   "error": ValueError}[ending]
            with pytest.raises(err):
                g.run(torch.zeros(4), _Port.batch_at, 40)
        assert _process_state() == before
        assert before["writers"] == []
        assert os.path.exists(tmp_path / "flight" / "GOODPUT.json")
        if ending == "oom":
            assert [f for f in os.listdir(tmp_path / "flight")
                    if f.startswith("flight-oom-")]
    finally:
        trace.set_tracer(prev_tr)


def test_host_reads_are_checks_plus_snapshots(tmp_path):
    """A preempted run and its resume with a rollback between: each
    guard's reads are its health checks plus its snapshots."""
    plan = faults.parse("nan@3x3;preempt@12")
    for _ in range(2):
        g = TrainGuard(_Port.sgd_step(), _cfg(_Port, tmp_path, check_every=2,
                                              save_every_steps=4),
                       plan=plan)
        _, rep = g.run(torch.zeros(4), _Port.batch_at, 16)
        assert g.host_reads == g.health_checks + rep.checkpoints
    assert rep.status == "completed" and rep.resumed_from == 12


def test_jax_manager_reads_the_port_guard_manifest(tmp_path):
    """The port guard's MANIFEST.json and checkpoint files are the JAX
    package's format: its ``CheckpointManager`` lists the same steps,
    ``verify`` passes every file, and its newest payload holds the port's
    final leaves (a bf16 leaf as a bf16 array)."""
    import ml_dtypes

    def step(state, batch):
        w, h = state
        return (w - 0.1 * (w - batch), (h.float() + batch).to(h.dtype)), \
            w.sum()
    g = TrainGuard(step, _cfg(_Port, tmp_path, save_every_steps=3,
                              check_every=3, keep_last=2))
    (w, h), rep = g.run((torch.zeros(4), torch.zeros(4,
                                                     dtype=torch.bfloat16)),
                        _Port.batch_at, 10)
    jm = jck.CheckpointManager(str(tmp_path), keep_last=2)
    steps = jm.all_steps()
    assert steps == _manifest_steps(tmp_path) == [9, 10]
    for s in steps:
        jckpt.verify(jm.path_for(s))
    ck_step, payload = jm.load_latest()
    assert ck_step == payload["step"] == 10
    jw, jh = payload["leaves"]
    assert np.array_equal(np.asarray(jw), w.numpy())
    assert np.asarray(jh).dtype == ml_dtypes.bfloat16
    assert np.array_equal(np.asarray(jh).astype(np.float32),
                          h.float().numpy())


def test_generator_in_the_state_resumes_bitwise(tmp_path):
    """A step that draws dropout noise from a ``torch.Generator`` carried
    in the state: preempt + resume and a nan rollback both end on the
    clean run's bits, because the generator's state is saved and set back
    with the tensors."""
    def step(state, batch):
        w, gen = state
        keep = (torch.rand(4, generator=gen) >= 0.5).float()
        return (w - 0.1 * keep * (w - batch), gen), ((w - batch) ** 2).sum()

    def start():
        return torch.zeros(4), torch.Generator().manual_seed(7)
    (ref, _), _ = TrainGuard(step, _cfg(_Port, tmp_path / "ref")).run(
        start(), _Port.batch_at, 20)
    plan = faults.parse("preempt@7")
    TrainGuard(step, _cfg(_Port, tmp_path / "p"), plan=plan).run(
        start(), _Port.batch_at, 20)
    (w, _), rep = TrainGuard(step, _cfg(_Port, tmp_path / "p"),
                             plan=plan).run(start(), _Port.batch_at, 20)
    assert rep.resumed_from == 7 and torch.equal(w, ref)
    (w, _), rep = TrainGuard(step, _cfg(_Port, tmp_path / "n",
                                        nonfinite_streak=2),
                             plan=faults.parse("nan@6x2")).run(
        start(), _Port.batch_at, 20)
    assert rep.rollbacks == 1 and torch.equal(w, ref)


def test_controller_runs_and_disabled_is_dropped():
    """The former stop is gone: ``TrainGuard(controller=...)`` runs.  A
    disabled controller is dropped (no ledger doc), an enabled one rides
    each health check and leaves its ``CONTROL.json`` doc in the
    report."""
    from apex_tpu_torch.control import (ControlConfig, RunController,
                                        control_violations)
    off = RunController(ControlConfig(enabled=False))
    _, rep = TrainGuard(_Port.sgd_step(), GuardConfig(enabled=True,
                                                      check_every=2),
                        controller=off).run(torch.zeros(4),
                                            _Port.batch_at, 6)
    assert rep.control is None and off.windows == 0
    on = RunController(ControlConfig(enabled=True))
    _, rep = TrainGuard(_Port.sgd_step(), GuardConfig(enabled=True,
                                                      check_every=2),
                        controller=on).run(torch.zeros(4),
                                           _Port.batch_at, 6)
    assert on.windows == 3 and control_violations(rep.control) == []


def test_world_size_mismatch_without_a_resharder(tmp_path):
    """A manifest written at world 2 resumed at world 1 with no resharder
    installed raises the typed error, as the JAX guard does without
    ``apex_tpu.elastic``."""
    from apex_tpu_torch.resilience import WorldSizeMismatchError
    assert pguard.get_resharder() is None
    plan = faults.parse("preempt@3")
    TrainGuard(_Port.sgd_step(), _cfg(_Port, tmp_path, world_size=2),
               plan=plan).run(torch.zeros(4), _Port.batch_at, 8)
    with pytest.raises(WorldSizeMismatchError):
        TrainGuard(_Port.sgd_step(), _cfg(_Port, tmp_path, world_size=1),
                   plan=plan).run(torch.zeros(4), _Port.batch_at, 8)


# ---------------------------------------------------------------------------
# the imagenet example's --auto-resume entry
# ---------------------------------------------------------------------------

def _rn18(seed=0):
    from apex_tpu_torch.models import resnet18_config, resnet_init
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = resnet18_config(width=8, num_classes=64)
    params, bn = resnet_init(torch.Generator().manual_seed(seed), cfg,
                             device="cpu")
    st = amp.initialize(params, FusedAdam(lr=1e-3), opt_level="O2",
                        verbosity=0)
    return cfg, st, bn


def _guarded(st, bn, cfg, src, steps, ckpt, **kw):
    """``resnet_guarded_run`` under ``resnet_auto_resume_guard``, with its
    guard: (amp_state, bn_state, report, status, guard)."""
    from apex_tpu_torch.train import (resnet_auto_resume_guard,
                                      resnet_guarded_run)
    log = kw.pop("log", None)
    g = resnet_auto_resume_guard(cfg, steps, ckpt_dir=str(ckpt), log=log,
                                 **kw)
    return resnet_guarded_run(st, bn, g, src, steps, log=log) + (g,)


def _same_state(a, b):
    from apex_tpu_torch.utils.pytree import tree_leaves
    (sa, ba), (sb, bb) = a, b
    la = pguard._leaves((sa, ba))
    lb = pguard._leaves((sb, bb))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)) \
        and len(tree_leaves(ba)) > 0


def test_resnet_auto_resume_synthetic_preempt_bitwise(tmp_path):
    """ResNet-18 (width 8) under amp O2 + FusedAdam through
    ``resnet_guarded_run`` on the step-addressable synthetic batches: a
    preempted run returns status 3, the rerun resumes and returns 0, and
    the final state is the uninterrupted run's bits; the batches are the
    example's ``synthetic_batch_at`` at this size."""
    lines = []
    src = resnet_guard_batches(None, "python", 4, 0, 6, hw=32,
                               device="cpu")
    assert callable(src)
    cfg, st, bn = _rn18()
    ref = _guarded(st, bn, cfg, src, 6, tmp_path / "ref", save_every=2,
                   print_freq=2, log=lines.append)
    assert ref[3] == 0 and ref[2].status == "completed"
    plan = faults.parse("preempt@3")
    cfg, st, bn = _rn18()
    got = _guarded(st, bn, cfg, src, 6, tmp_path / "ck", save_every=2,
                   print_freq=2, plan=plan, log=lines.append)
    assert got[3] == 3 and got[2].status == "preempted"
    cfg, st, bn = _rn18(seed=1)
    got = _guarded(st, bn, cfg, src, 6, tmp_path / "ck", save_every=2,
                   print_freq=2, plan=plan, log=lines.append)
    assert got[3] == 0 and got[2].resumed_from == 3
    assert _same_state(got[:2], ref[:2])
    assert "=> guard resumed from step 3" in lines
    assert any(line.startswith("Step [2/6]") for line in lines)
    x, y = resnet_synthetic_batch_at(4, 0, 5, hw=32, device="cpu")
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence([0,
                                                                      5])))
    labels = rng.integers(0, 64, size=(4,))
    pool = np.random.RandomState(1234).rand(64, 32, 32, 3).astype(
        np.float32)
    want = pool[labels] + 0.08 * rng.standard_normal((4, 32, 32, 3),
                                                     dtype=np.float32)
    assert np.array_equal(x.numpy(), want)
    assert np.array_equal(y.numpy(), labels.astype(np.int32))


def test_resnet_auto_resume_sharded_source_records_the_cursor(tmp_path):
    """The ``.npz`` shard source: seekable, so the preempted run's
    manifest names the cursor and the resume ends on the clean run's
    bits."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        np.savez(data / f"shard-{i:03d}.npz",
                 images=rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                 labels=rng.integers(0, 10, 8).astype(np.int64))
    src = resnet_guard_batches(str(data), "python", 4, 0, 6, device="cpu")
    assert callable(src) and callable(getattr(src, "cursor"))
    cfg, st, bn = _rn18()
    ref = _guarded(st, bn, cfg, src, 6, tmp_path / "ref", save_every=2,
                   print_freq=2)
    plan = faults.parse("preempt@3")
    for seed in (0, 1):
        cfg, st, bn = _rn18(seed)
        src = resnet_guard_batches(str(data), "python", 4, 0, 6,
                                   device="cpu")
        got = _guarded(st, bn, cfg, src, 6, tmp_path / "ck", save_every=2,
                       print_freq=2, plan=plan)
        if seed == 0:
            meta = CheckpointManager(str(tmp_path / "ck")).manifest_meta()
            assert meta["data"]["cursor"]["step"] == 3
    assert got[3] == 0 and got[2].resumed_from == 3
    assert _same_state(got[:2], ref[:2])


def test_resnet_auto_resume_native_source(tmp_path):
    """The native ring over memmapped ``images.npy`` / ``labels.npy``: an
    iterator, so a run completes, a stall past ``wait_timeout`` raises
    ``LoaderStallError``, and a needed rollback aborts with
    ``GuardAbort``."""
    from apex_tpu_torch.data import LoaderStallError
    data = tmp_path / "npy"
    data.mkdir()
    rng = np.random.default_rng(1)
    np.save(data / "images.npy",
            rng.standard_normal((12, 32, 32, 3)).astype(np.float32))
    np.save(data / "labels.npy", rng.integers(0, 10, 12).astype(np.int32))
    src = resnet_guard_batches(str(data), "native", 4, 0, 4, device="cpu")
    assert not callable(src)
    cfg, st, bn = _rn18()
    *_, rep, code, g = _guarded(st, bn, cfg, src, 4, tmp_path / "a",
                                print_freq=2)
    assert g.host_reads == g.health_checks + rep.checkpoints
    assert code == 0 and rep.status == "completed"
    faults.install(faults.parse("loader_stall@2:0.6"))
    src = resnet_guard_batches(str(data), "native", 4, 0, 4, device="cpu",
                               wait_timeout=0.2)
    with pytest.raises(LoaderStallError):
        _guarded(st, bn, cfg, src, 4, tmp_path / "b", print_freq=2)
    faults.install(None)
    src = resnet_guard_batches(str(data), "native", 4, 0, 8, device="cpu")
    with pytest.raises(GuardAbort, match="plain iterator"):
        _guarded(st, bn, cfg, src, 8, tmp_path / "c", print_freq=1,
                 plan=faults.parse("nan@1x6"))
