"""Resilience of the PyTorch port against the JAX package's.

The JAX package's ``tests/L0/test_resilience.py`` fault cases (the spec
grammar and its aliases, one-shot firing, ``skip_until``, the
``APEX_TPU_FAULTS`` cache, ``corrupt``, the collective wrapper, the
stalling iterator), its ``CheckpointManager`` cases (keep-last rotation,
``latest()`` skipping corrupt and partial files, a missing or corrupt
``MANIFEST.json``) and its scaler floor hook run against
``apex_tpu_torch``.  Both packages parse the same specs into the same
plans and fire them at the same steps, and each package's manager resumes
from a directory the other wrote: same file names, same manifest JSON,
bit-equal leaves.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import checkpoint as jckpt
from apex_tpu.amp import scaler as jscaler
from apex_tpu.resilience import ckpt as jck
from apex_tpu.resilience import faults as jfaults

from apex_tpu_torch import resilience
from apex_tpu_torch.amp import scaler
from apex_tpu_torch.resilience import (CheckpointManager, CollectiveFault,
                                       FaultError, StallingIterator, faults)


@pytest.fixture(autouse=True)
def _no_installed_plan():
    prev, jprev = faults.install(None), jfaults.install(None)
    yield
    faults.install(prev)
    jfaults.install(jprev)


# ---------------------------------------------------------------------------
# fault grammar and plan semantics (tests/L0/test_resilience.py:51-152)
# ---------------------------------------------------------------------------

def test_fault_spec_grammar():
    p = faults.parse("nan@5x3;preempt@40;loader_stall@10:1.5;"
                     "collective_fail@2;seed=7")
    assert p.seed == 7
    assert [s.kind for s in p.specs] == ["nan", "preempt", "loader_stall",
                                         "collective_fail"]
    assert p.specs[0].count == 3 and p.specs[2].arg == 1.5
    q = faults.parse("nan_grads@1;inf_grads@2;sigterm@3")
    assert [s.kind for s in q.specs] == ["nan", "inf", "preempt"]
    with pytest.raises(FaultError, match="unknown fault kind"):
        faults.parse("frobnicate@3")
    with pytest.raises(FaultError, match="bad fault entry"):
        faults.parse("nan@")
    with pytest.raises(FaultError, match="bad seed"):
        faults.parse("seed=xyz")


SPECS = ["nan@5x3;preempt@40;loader_stall@10:1.5;collective_fail@2;seed=7",
         "nan_grads@1;inf_grads@2;sigterm@3",
         "shard_corrupt@3:17;index_missing@0",
         "resize@6:4;request_flood@8:16;straggler@4x12:3;"
         "goodput_degrade@4x8:0.05;oom@9"]
BAD_SPECS = ["frobnicate@3", "nan@", "seed=xyz", "resize@3", "resize@3:1.5",
             "request_flood@2", "straggler@1:1", "goodput_degrade@1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    p, j = faults.parse(spec), jfaults.parse(spec)
    assert p.seed == j.seed
    assert [tuple(vars(s).values()) for s in p.specs] == \
        [tuple(vars(s).values()) for s in j.specs]
    assert faults.KINDS == jfaults.KINDS
    fired = [[(k, st) for k in faults.KINDS for st in range(50)
              if plan.fire(k, st) is not None] for plan in (p, j)]
    assert fired[0] == fired[1]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_in_both(spec):
    with pytest.raises(jfaults.FaultError) as je:
        jfaults.parse(spec)
    with pytest.raises(FaultError) as pe:
        faults.parse(spec)
    assert str(pe.value) == str(je.value)


def test_fault_plan_fires_once_per_scheduled_step():
    p = faults.parse("nan@5x3")
    assert p.fire("nan", 4) is None
    assert all(p.fire("nan", s) is not None for s in (5, 6, 7))
    assert p.fire("nan", 8) is None
    assert p.fire("inf", 5) is None
    p.reset()
    assert p.fire("nan", 5) is not None


def test_fault_plan_skip_until_consumes_elapsed_faults():
    spec = "preempt@7;nan@20;nan@7;inf@5x5;resize@7:2"
    p, j = faults.parse(spec), jfaults.parse(spec)
    p.skip_until(7)
    j.skip_until(7)
    assert [s.kind for s in p.pending()] == [s.kind for s in j.pending()]
    assert p.fire("preempt", 7) is None and p.fire("preempt", 99) is None
    assert p.fire("nan", 7) is not None
    assert p.fire("nan", 20) is not None
    assert sum(1 for st in (7, 8, 9, 10, 11) if p.fire("inf", st)) == 3


def test_env_spec_installs_and_caches(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FAULTS", "nan@3")
    p1 = faults.active_plan()
    assert p1 is not None and p1.specs[0].kind == "nan"
    assert faults.active_plan() is p1
    mine = faults.parse("inf@1")
    faults.install(mine)
    assert faults.active_plan() is mine
    faults.install(None)
    monkeypatch.delenv("APEX_TPU_FAULTS")
    assert faults.active_plan() is None


def test_corrupt_poisons_float_leaves_only():
    tree = {"w": np.ones(3, np.float32), "i": np.arange(3, dtype=np.int32),
            "t": torch.ones(2, dtype=torch.bfloat16),
            "ti": torch.arange(3), "s": "tag", "n": None}
    out = faults.corrupt(tree, "nan")
    assert np.isnan(out["w"]).all()
    assert torch.isnan(out["t"]).all() and out["t"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["i"], tree["i"])
    assert torch.equal(out["ti"], tree["ti"])
    assert out["s"] == "tag" and out["n"] is None
    assert torch.isinf(faults.corrupt(tree, "inf")["t"]).all()
    j = jfaults.corrupt({"w": np.ones(3, np.float32),
                         "i": np.arange(3, dtype=np.int32)}, "nan")
    assert np.isnan(j["w"]).all() and np.isnan(out["w"]).all()


def test_collective_wrapper_fires_on_scheduled_call():
    plan = faults.parse("collective_fail@1")
    calls = []
    wrapped = faults.wrap_collective(lambda x: calls.append(x) or x,
                                     plan=plan, name="allreduce")
    assert wrapped(1) == 1
    with pytest.raises(CollectiveFault, match="allreduce .call 1."):
        wrapped(2)
    assert wrapped(3) == 3
    assert calls == [1, 3]


def test_stalling_iterator_delays_scheduled_item():
    plan = faults.parse("loader_stall@1:0.1")
    t0 = time.perf_counter()
    assert list(StallingIterator(range(3), plan=plan)) == [0, 1, 2]
    assert time.perf_counter() - t0 >= 0.1
    assert not plan.pending("loader_stall")
    assert faults.maybe_stall(0, plan=faults.parse("loader_stall@0:0.01")) \
        == 0.01
    assert faults.maybe_stall(0, plan=faults.parse("nan@0")) == 0.0


@pytest.mark.parametrize("arg", [0.5, 1.0, 2.0, 3.0, 30.0, 1e3])
def test_straggler_delay_matches_jax(arg):
    assert faults.straggler_delay(arg) == jfaults.straggler_delay(arg)


def test_exports_match_jax_minus_the_guard():
    """The JAX package's exports; the guard's names, once missing, are
    among them now (``tests/test_torch_guard.py`` tests the guard)."""
    import apex_tpu.resilience as jres
    guard = {"guard", "TrainGuard", "GuardConfig", "GuardReport",
             "GuardAbort"}
    assert guard <= set(resilience.__all__)
    assert set(resilience.__all__) == set(jres.__all__)
    assert all(hasattr(resilience, n) for n in resilience.__all__)


# ---------------------------------------------------------------------------
# CheckpointManager (tests/L0/test_resilience.py:225-290)
# ---------------------------------------------------------------------------

def _payload(step):
    return {"step": step, "leaves": [torch.full((3,), float(step))]}


def test_manager_rotation_keeps_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (0, 10, 20, 30):
        mgr.save(s, _payload(s))
    assert mgr.all_steps() == [20, 30]
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".ckpt")]) == 2
    step, payload = mgr.load_latest()
    assert step == 30 and payload["leaves"][0][0] == 30.0
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointManager(str(tmp_path), keep_last=0)


def test_manager_latest_skips_corrupt_and_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    for s in (0, 10, 20):
        mgr.save(s, _payload(s))
    p20, p10 = mgr.path_for(20), mgr.path_for(10)
    open(p20, "wb").write(open(p20, "rb").read()[:10])
    open(p10, "wb").write(b"garbage")
    step, path = mgr.latest()
    assert step == 0 and path == mgr.path_for(0)
    step, payload = mgr.load_latest()
    assert step == 0 and payload["leaves"][0][0] == 0.0


def test_manager_survives_missing_or_corrupt_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    mgr.save(5, _payload(5))
    mgr.save(15, _payload(15))
    os.unlink(os.path.join(str(tmp_path), "MANIFEST.json"))
    assert mgr.load_latest()[0] == 15
    with open(os.path.join(str(tmp_path), "MANIFEST.json"), "w") as f:
        f.write("{not json")
    assert mgr.load_latest()[0] == 15
    assert mgr.manifest_meta() == {}
    mgr.save(25, _payload(25))
    doc = json.load(open(os.path.join(str(tmp_path), "MANIFEST.json")))
    assert [r["step"] for r in doc["checkpoints"]] == [5, 15, 25]


def test_manager_meta_and_load_latest_with_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2,
                            meta={"world_size": 1})
    mgr.update_meta({resilience.ckpt.META_DATA_KEY: {"seed": 3}})
    mgr.save(4, _payload(4))
    step, payload, meta = mgr.load_latest(with_meta=True)
    assert step == 4 and meta == {"world_size": 1, "data": {"seed": 3}}
    doc = json.load(open(os.path.join(str(tmp_path), "MANIFEST.json")))
    assert doc["version"] == 2 and doc["meta"] == meta
    mgr.set_meta(None)
    mgr.save(5, _payload(5))
    assert mgr.manifest_meta() == {}
    assert CheckpointManager(str(tmp_path / "empty")).load_latest() is None


def test_meta_keys_and_errors_match_jax():
    for name in ("MANIFEST", "META_LAYOUT_KEY", "META_WORLD_KEY",
                 "META_PLAN_KEY", "META_DATA_KEY"):
        assert getattr(resilience.ckpt, name) == getattr(jck, name)
    err = resilience.WorldSizeMismatchError(4, 2)
    assert isinstance(err, resilience.CheckpointError)
    assert (err.saved_world, err.live_world) == (4, 2)
    d = resilience.DataStreamMismatchError("a" * 64, "b" * 64)
    assert d.saved_digest == "a" * 64 and "aaaaaaaaaaaaaaaa" in str(d)
    assert issubclass(resilience.ManifestCompatWarning, UserWarning)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manager_directory_crosses(writer, tmp_path):
    """Either package's manager resumes from the other's directory: the
    same files and manifest, and bit-equal leaves (bf16 included)."""
    vals = np.random.default_rng(4).standard_normal((3, 7)).astype(
        np.float32)
    meta = {"world_size": 1, "data": {"seed": 2, "cursor": {"step": 20}}}
    if writer == "jax":
        mgr = jck.CheckpointManager(str(tmp_path), keep_last=2, meta=meta)
        for s in (10, 20, 30):
            mgr.save(s, {"step": s, "w": jnp.asarray(vals * s, jnp.bfloat16),
                         "f": jnp.asarray(vals * s)})
        reader = CheckpointManager(str(tmp_path), keep_last=2)
    else:
        mgr = CheckpointManager(str(tmp_path), keep_last=2, meta=meta)
        for s in (10, 20, 30):
            t = torch.from_numpy(vals * s)
            mgr.save(s, {"step": s, "w": t.bfloat16(), "f": t})
        reader = jck.CheckpointManager(str(tmp_path), keep_last=2)
    assert sorted(os.listdir(tmp_path)) == [
        "MANIFEST.json", "ckpt-0000000020.ckpt", "ckpt-0000000030.ckpt"]
    assert reader.all_steps() == [20, 30]
    assert reader.latest() == (30, os.path.join(str(tmp_path),
                                                "ckpt-0000000030.ckpt"))
    step, payload, got_meta = reader.load_latest(with_meta=True)
    assert step == 30 and got_meta == meta
    want_bf16 = np.asarray(jnp.asarray(vals * 30, jnp.bfloat16)).view(
        np.uint16)
    if writer == "jax":
        w = resilience.ckpt._ckpt.restore_like(
            {"w": torch.zeros(3, 7, dtype=torch.bfloat16),
             "f": torch.zeros(3, 7)}, {"w": payload["w"], "f": payload["f"]})
        got_bf16 = w["w"].view(torch.int16).numpy().view(np.uint16)
        got_f = w["f"].numpy()
    else:
        got_bf16 = np.asarray(payload["w"]).view(np.uint16)
        got_f = np.asarray(payload["f"])
    np.testing.assert_array_equal(got_bf16, want_bf16)
    np.testing.assert_array_equal(got_f, vals * 30)
    # the reader's own save extends the other's manifest
    reader.save(40, {"step": 40})
    doc = json.load(open(os.path.join(str(tmp_path), "MANIFEST.json")))
    assert [r["step"] for r in doc["checkpoints"]] == [30, 40]
    assert jckpt.load(os.path.join(str(tmp_path), "ckpt-0000000040.ckpt"))[
        "step"] == 40


# ---------------------------------------------------------------------------
# scaler escalation hook (tests/L0/test_resilience.py:575)
# ---------------------------------------------------------------------------

def test_scaler_floor_pinned_hook():
    dyn = scaler.init("dynamic", init_scale=4.0, min_loss_scale=2.0,
                      device="cpu")
    assert scaler.floor_pinned(dyn, 2.0) is True
    assert scaler.floor_pinned(dyn, 4.0) is False
    static = scaler.init(128.0, device="cpu")
    assert scaler.floor_pinned(static, 1.0) is False
    jdyn = jscaler.init("dynamic", init_scale=4.0, min_loss_scale=2.0)
    for v in (1.0, 2.0, 3.0, 4.0):
        assert scaler.floor_pinned(dyn, v) == jscaler.floor_pinned(jdyn, v)
