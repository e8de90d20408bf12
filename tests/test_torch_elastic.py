"""The port's ``apex_tpu_torch.elastic`` against the JAX package's
``apex_tpu.elastic``.

- Bit for bit: ``reshard_payload`` and ``repartition_data`` give the JAX
  functions' arrays and dicts on the same random payloads (hypothesis
  draws the worlds (N, M), divisible or not, the used prefix, fp32 flat
  fields and per-rank error-feedback residual stacks), the ``stacked``
  expert lattice 2 -> 3 included; both raise the same typed errors with
  the same messages on a model change, a bad ``row_used``, a lattice the
  content does not fit and a manifest without a layout; their events
  carry the same names and fields; ``replan`` picks the JAX winner.
- With real ranks (spawned gloo ranks, ``tests/_torch_dist.py``): the
  zero1 + int8 error-feedback flagship step under the port's guard at
  world 4, killed by ``resize@6:2``, writes the JAX payload (flat fields
  ``flat_total`` long, the residual stack ``(4, flat_total)``); resumed
  at world 2 it raises ``WorldSizeMismatchError`` naming 4 and 2 without
  elastic, and with it finishes bitwise equal (parameters, moments,
  residual) to a clean world-2 run from the same checkpoint imported
  independently (a numpy re-chunk written out in the test helper).  2 -> 4
  grows bitwise equal to the independent 4-way import and within fp32
  tolerance (2e-2 absolute, 0.25 relative: the JAX test's bound) of the
  clean world-2 continuation: the wider group quantizes other local
  gradients.  Every rank's reads are its checks plus its snapshots, with
  two gathers a snapshot beside them.
- Port against JAX on a trajectory: the fp32-scheme run resized 4 -> 2
  (the JAX weights, the JAX batches) gives losses within 1e-5 relative of
  the JAX harness's at the same worlds, step for step.
- A world-1 snapshot with ``state_shards`` is the plain one, byte for
  byte; a manifest without meta degrades to a same-world resume with
  ``ManifestCompatWarning``.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

import apex_tpu.elastic as jelastic
from apex_tpu.models import TransformerConfig as JCfg
from apex_tpu.models import transformer_init as jinit
from apex_tpu.models import transformer_loss as jloss
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu.parallel import create_mesh as jmesh
from apex_tpu.parallel import plan as jplan
from apex_tpu.parallel import weight_update as jwu
from apex_tpu.parallel.mesh import shard_map as jshard_map
from apex_tpu.resilience import GuardConfig as JGuardConfig
from apex_tpu.resilience import TrainGuard as JTrainGuard
from apex_tpu.resilience import WorldSizeMismatchError as JWSME
from apex_tpu.resilience import faults as jfaults
from apex_tpu.resilience import guard as jguard
from apex_tpu.utils.pallas import _to_varying, has_vma

import _torch_dist
import apex_tpu_torch.elastic as elastic
from apex_tpu_torch.parallel import plan as pplan
from apex_tpu_torch.resilience import (CheckpointManager, GuardConfig,
                                       ManifestCompatWarning, TrainGuard,
                                       WorldSizeMismatchError, faults,
                                       guard as pguard)

LANE = 128
SEQ = 20
CFG_KW = dict(max_len=SEQ)
INT8 = "int8_blockscale:min_bytes=0"
TINY_PROFILE = dict(
    name="tiny", flops=1e9, bytes_accessed=1e8, params_bytes=1 << 20,
    optimizer_bytes=3 << 20, activations_bytes=1 << 20,
    batch_bytes=1 << 16, temps_bytes=1 << 18, output_bytes=1 << 10,
    platform="cpu")
#: the fp32 trajectory's bound, port against JAX: two frameworks' product
#: orders over 10 Adam steps at lr 1e-2
TRAJ_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_hooks():
    prev = (pguard.set_resharder(None), pplan.set_replan_hook(None),
            faults.install(None), jguard.set_resharder(None),
            jplan.set_replan_hook(None), jfaults.install(None))
    yield
    pguard.set_resharder(prev[0])
    pplan.set_replan_hook(prev[1])
    faults.install(prev[2])
    jguard.set_resharder(prev[3])
    jplan.set_replan_hook(prev[4])
    jfaults.install(prev[5])


# ---------------------------------------------------------------------------
# bit for bit against the JAX functions
# ---------------------------------------------------------------------------

def _total(used, world):
    chunk = LANE * world
    return -(-used // chunk) * chunk


def _flat(rng, used, total):
    a = np.zeros((total,), np.float32)
    a[:used] = rng.randn(used).astype(np.float32)
    return a


def _both(fn_j, fn_p):
    """(JAX result or exception, port result or exception)."""
    out = []
    for fn in (fn_j, fn_p):
        try:
            out.append(fn())
        except Exception as e:   # compared below, class and message
            out.append(e)
    return out


def _recorder():
    seen = []
    return seen, lambda name, **f: seen.append((name, f))


def _strip_seconds(events):
    return [(n, {k: v for k, v in f.items() if k != "seconds"})
            for n, f in events]


def _payload(rng, n, used, extra_stack):
    """A canonical N-way payload: a replicated leaf, three flat fields
    (master, two moments), an int8-EF residual stack and a scalar."""
    tot = _total(used, n)
    leaves = [rng.randn(3, 5).astype(np.float32),
              _flat(rng, used, tot), _flat(rng, used, tot),
              _flat(rng, used, tot),
              np.stack([_flat(rng, used, tot) for _ in range(n)])
              if extra_stack else np.zeros((n, tot), np.float32),
              np.asarray(7, np.int32)]
    meta = {"world_size": n, "plan": {"dp": n},
            "layout": {"flat_total": tot, "used": used, "chunk": LANE * n,
                       "lane": LANE}}
    return {"step": 11, "leaves": leaves}, meta


def _templates(m, used):
    tot = _total(used, m)
    shapes = [(3, 5), (tot,), (tot,), (tot,), (m, tot), ()]
    dts = ["float32"] * 5 + ["int32"]
    jt = {f"l{i}": jnp.zeros(s, d) for i, (s, d) in
          enumerate(zip(shapes, dts))}
    pt = {f"l{i}": torch.zeros(s, dtype=getattr(torch, d)) for i, (s, d)
          in enumerate(zip(shapes, dts))}
    return jt, pt


@settings(max_examples=30, deadline=None, database=None)
@given(n=st.integers(1, 8), m=st.integers(1, 8),
       used=st.integers(1, 3000), seed=st.integers(0, 2 ** 16),
       stack=st.booleans())
@example(n=3, m=1, used=7, seed=6, stack=True)
def test_reshard_payload_bitwise_matches_jax(n, m, used, seed, stack):
    payload, meta = _payload(np.random.RandomState(seed), n, used, stack)
    jt, pt = _templates(m, used)
    jseen, jemit = _recorder()
    pseen, pemit = _recorder()
    jout, pout = _both(
        lambda: jelastic.reshard_payload(jt, payload, meta, m, emit=jemit),
        lambda: elastic.reshard_payload(pt, payload, meta, m, emit=pemit))
    assert jout["step"] == pout["step"] == 11
    for a, b in zip(jout["leaves"], pout["leaves"]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _strip_seconds(jseen) == _strip_seconds(pseen)
    assert pseen[0][0] == "elastic.reshard" and "seconds" in pseen[0][1]
    # the residual's collapse onto replica 0 is the JAX package's, bit for
    # bit, and each element's sum is the rows' exact sum within what fp32
    # summation of n terms can lose: (n - 1) * 2**-24 * sum(|x_i|)
    res = np.asarray(pout["leaves"][4])
    rows = payload["leaves"][4]
    np.testing.assert_array_equal(res, np.asarray(jout["leaves"][4]))
    if n == m:
        np.testing.assert_array_equal(res, rows)
    else:
        assert not np.any(res[1:]) and not np.any(res[0, used:])
        live = rows[:, :used].astype(np.float64)
        err = np.abs(res[0, :used].astype(np.float64) - live.sum(axis=0))
        assert np.all(err <= (n - 1) * 2.0 ** -24
                      * np.abs(live).sum(axis=0))


@pytest.mark.parametrize("n,m", [(8, 4), (4, 8), (8, 3), (3, 8), (2, 5),
                                 (8, 8)])
def test_reshard_roundtrip_n_to_m_to_n_bitwise(n, m):
    """N -> M -> N gives every flat field back bit for bit, including
    non-divisible pairs (the JAX test's pairs)."""
    used = 1000
    payload, meta = _payload(np.random.RandomState(n * 10 + m), n, used,
                             False)
    _, pt_m = _templates(m, used)
    _, pt_n = _templates(n, used)
    there = elastic.reshard_payload(pt_m, payload, meta, m)
    meta_m = {"world_size": m,
              "layout": {"flat_total": _total(used, m), "used": used}}
    back = elastic.reshard_payload(pt_n, there, meta_m, n)
    for a, b in zip(payload["leaves"][:4], back["leaves"][:4]):
        np.testing.assert_array_equal(a, np.asarray(b))


def _pack_lattice(flat, rows):
    """The contiguous-fill row lattice of the JAX test (padding only at
    the global tail)."""
    per = -(-flat.shape[0] // rows)
    row_total = -(-per // LANE) * LANE
    row_used = [max(min(flat.shape[0] - i * row_total, row_total), 0)
                for i in range(rows)]
    lat = np.zeros((rows * row_total,), flat.dtype)
    lat[:flat.shape[0]] = flat
    return lat.reshape(rows, row_total), {
        "rows": rows, "row_total": row_total, "row_used": row_used}


def _stacked_meta(world, length, block):
    return {"world_size": world,
            "layout": {"flat_total": block["rows"] * block["row_total"],
                       "used": length, "stacked": dict(block)}}


@settings(max_examples=15, deadline=None, database=None)
@given(n=st.integers(1, 6), m=st.integers(1, 6),
       length=st.integers(1, 2000), seed=st.integers(0, 2 ** 16))
def test_stacked_lattice_bitwise_matches_jax(n, m, length, seed):
    flat = np.random.RandomState(seed).randn(length).astype(np.float32)
    lat_n, blk_n = _pack_lattice(flat, n)
    lat_m, _ = _pack_lattice(flat, m)
    meta = _stacked_meta(n, length, blk_n)
    jout = jelastic.reshard_payload(
        {"lat": jnp.zeros(lat_m.shape, jnp.float32)},
        {"step": 1, "leaves": [lat_n]}, meta, m, emit=lambda *a, **k: 0)
    pout = elastic.reshard_payload(
        {"lat": torch.zeros(lat_m.shape)}, {"step": 1, "leaves": [lat_n]},
        meta, m, emit=lambda *a, **k: 0)
    np.testing.assert_array_equal(np.asarray(jout["leaves"][0]),
                                  pout["leaves"][0])
    np.testing.assert_array_equal(pout["leaves"][0], lat_m)


def test_expert_lattice_2_to_3_bitwise_and_back():
    """The ep lattice resize of the JAX chaos test, 2 -> 3 -> 2."""
    flat = np.random.RandomState(3).randn(4000).astype(np.float32)
    lat2, blk2 = _pack_lattice(flat, 2)
    lat3, blk3 = _pack_lattice(flat, 3)
    assert blk2["row_total"] * 3 != blk3["rows"] * blk3["row_total"]
    out = elastic.reshard_payload({"lat": torch.zeros(lat3.shape)},
                                  {"step": 4, "leaves": [lat2]},
                                  _stacked_meta(2, 4000, blk2), 3)
    np.testing.assert_array_equal(out["leaves"][0], lat3)
    back = elastic.reshard_payload({"lat": torch.zeros(lat2.shape)},
                                   {"step": 4, "leaves": [lat3]},
                                   _stacked_meta(3, 4000, blk3), 2)
    np.testing.assert_array_equal(back["leaves"][0], lat2)


def _error_cases():
    meta = {"world_size": 8,
            "layout": {"flat_total": 1024, "used": 512, "chunk": 1024,
                       "lane": 128}}
    flat = np.arange(1, 513, dtype=np.float32)
    lat, blk = _pack_lattice(flat, 4)
    smeta = _stacked_meta(4, 512, blk)
    return {
        "leaf_count": ((512,), {"step": 1, "leaves": [
            np.zeros((1024,), np.float32), np.zeros((4,), np.float32)]},
            meta, 4),
        "shape": ((512,), {"step": 1, "leaves": [
            np.zeros((768,), np.float32)]}, meta, 4),
        "no_layout": ((512,), {"step": 1, "leaves": []},
                      {"world_size": 8}, 4),
        "nonzero_tail": ((512,), {"step": 1, "leaves": [
            np.ones((1024,), np.float32)]}, meta, 4),
        "lattice_too_small": ((2, 128), {"step": 0, "leaves": [lat]},
                              smeta, 2),
        "lattice_dirty_tail": ((2, 256), {"step": 0, "leaves": [lat]},
                               _stacked_meta(4, 484, dict(
                                   blk, row_used=[100, 128, 128, 128])), 2),
        "row_used_arity": ((2, 256), {"step": 0, "leaves": [lat]},
                           _stacked_meta(4, 512, dict(
                               blk, row_used=[128, 128])), 2),
    }


@pytest.mark.parametrize("case", sorted(_error_cases()))
def test_typed_errors_match_jax(case):
    shape, payload, meta, live = _error_cases()[case]
    jout, pout = _both(
        lambda: jelastic.reshard_payload({"a": jnp.zeros(shape)}, payload,
                                         meta, live, emit=lambda *a, **k: 0),
        lambda: elastic.reshard_payload({"a": torch.zeros(shape)}, payload,
                                        meta, live, emit=lambda *a, **k: 0))
    if case == "nonzero_tail":
        # a nonzero tail is refused by rechunk_flat in both packages
        assert type(jout) is ValueError and type(pout) is ValueError
    else:
        assert isinstance(jout, JWSME) and isinstance(
            pout, WorldSizeMismatchError)
        assert (pout.saved_world, pout.live_world) == (
            jout.saved_world, jout.live_world)
    jdetail = str(jout).rsplit(" [", 1)[-1]
    pdetail = str(pout).rsplit(" [", 1)[-1]
    assert pdetail == jdetail


@settings(max_examples=25, deadline=None, database=None)
@given(gb=st.integers(1, 64), saved=st.integers(1, 8),
       live=st.integers(0, 9), with_block=st.booleans(),
       cursor=st.booleans())
def test_repartition_data_matches_jax(gb, saved, live, with_block, cursor):
    data = {"global_batch": gb, "world": saved, "index_digest": "ab" * 8}
    if cursor:
        data["cursor"] = {"step": 12, "epoch": 1}
    meta = {"world_size": saved}
    if with_block:
        meta["data"] = data
    jseen, jemit = _recorder()
    pseen, pemit = _recorder()
    jout, pout = _both(
        lambda: jelastic.repartition_data(meta, live, emit=jemit),
        lambda: elastic.repartition_data(meta, live, emit=pemit))
    if isinstance(jout, Exception):
        assert type(pout).__name__ == type(jout).__name__
        assert str(pout).rsplit(" [", 1)[-1] == str(jout).rsplit(" [", 1)[-1]
    else:
        assert pout == jout
    assert pseen == jseen


def test_replan_picks_the_jax_winner_and_emits_the_same_event():
    jprof = jplan.ModelProfile(**TINY_PROFILE)
    pprof = pplan.ModelProfile(**TINY_PROFILE)
    for chips in (1, 2, 4, 8):
        jseen, jemit = _recorder()
        pseen, pemit = _recorder()
        jw = jelastic.replan(chips, profile=jprof, saved_knobs={"dp": 8},
                             emit=jemit)
        pw = elastic.replan(chips, profile=pprof, saved_knobs={"dp": 8},
                            emit=pemit)
        assert pw.knobs() == jw.knobs() and pw.chips == chips
        assert pw.predicted_step_ms == pytest.approx(jw.predicted_step_ms,
                                                     rel=1e-9)
        (jn, jf), (pn, pf) = jseen[0], pseen[0]
        assert jn == pn == "elastic.replan"
        assert set(jf) == set(pf)
        assert {k: pf[k] for k in ("chips", "candidates", "old_knobs",
                                   "new_knobs")} == \
            {k: jf[k] for k in ("chips", "candidates", "old_knobs",
                                "new_knobs")}


def test_install_hooks_the_guard_and_the_planner():
    assert elastic.installed() is None
    er = elastic.install(profile=pplan.ModelProfile(**TINY_PROFILE))
    assert elastic.installed() is er and pguard.get_resharder() is er
    hook = pplan.get_replan_hook()
    assert hook is not None
    assert hook(pplan.Plan(dp=8), 4).chips == 4
    elastic.uninstall()
    assert elastic.installed() is None and pplan.get_replan_hook() is None
    assert set(jelastic.__all__) == set(elastic.__all__)
    assert elastic.can_reshard({"world_size": 2, "layout": {
        "flat_total": 256, "used": 0}})
    assert not elastic.can_reshard({"world_size": 2})


# ---------------------------------------------------------------------------
# in-process guard cases
# ---------------------------------------------------------------------------

def _sgd_step(w, batch):
    return w - 0.1 * 2 * (w - batch), ((w - batch) ** 2).sum()


def _batch_at(i):
    return torch.from_numpy(
        np.random.RandomState(i).randn(4).astype(np.float32))


def test_old_manifest_degrades_with_typed_warning(tmp_path):
    d = tmp_path / "old"
    cfg = lambda: GuardConfig(ckpt_dir=str(d), save_every_steps=2,  # noqa
                              check_every=2, enabled=True, world_size=1,
                              backoff_seconds=0.01)
    _, r1 = TrainGuard(_sgd_step, cfg(), plan=faults.parse("preempt@4")
                       ).run(torch.zeros(4), _batch_at, 8)
    assert r1.status == "preempted"
    mpath = d / "MANIFEST.json"
    doc = json.loads(mpath.read_text())
    doc.pop("meta", None)
    mpath.write_text(json.dumps(doc))
    with pytest.warns(ManifestCompatWarning, match="same-world"):
        _, r2 = TrainGuard(_sgd_step, cfg(),
                           elastic=elastic.ElasticResume()).run(
            torch.zeros(4), _batch_at, 8)
    assert r2.status == "completed" and r2.resumed_from == 4
    assert r2.resharded_from is None


def test_world1_snapshot_with_state_shards_is_the_plain_one(tmp_path):
    """At world 1 the snapshot of a sharded state is byte for byte the one
    the guard writes without ``state_shards``, and it makes no gather."""
    from apex_tpu_torch.train import flagship_guard_step

    def run(d, shards):
        carry, step, layout, sh = flagship_guard_step(
            _torch_dist.tiny_transformer_cfg(**CFG_KW),
            ddp_kwargs={"collective_scheme": INT8}, device="cpu")
        g = TrainGuard(step, GuardConfig(
            ckpt_dir=str(d), save_every_steps=2, check_every=2,
            enabled=True, world_size=1, ckpt_meta={"layout": layout}),
            state_shards=sh if shards else None)
        g.run(carry, lambda i: _torch_dist.elastic_tokens(i, 1, 0), 4)
        return g

    def body(tmp):
        ga = run(tmp / "a", True)
        gb = run(tmp / "b", False)
        return ga, gb
    ga, gb = _torch_dist.run_in_process(lambda r, w: body(tmp_path),
                                        tmp_path)
    assert ga.gathers == 0 and ga.host_reads == gb.host_reads
    files = sorted(f for f in os.listdir(tmp_path / "a")
                   if f.endswith(".ckpt"))
    assert files == sorted(f for f in os.listdir(tmp_path / "b")
                           if f.endswith(".ckpt")) and files
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes()


# ---------------------------------------------------------------------------
# real ranks: zero1 + int8 error feedback on spawned gloo ranks
# ---------------------------------------------------------------------------

def _jax_harness(world, scheme):
    """The JAX elastic test's harness (zero1 over the first ``world`` CPU
    devices, FusedAdam(lr=1e-2), an error-feedback residual) at
    ``scheme``."""
    mesh = jmesh({"data": world}, jax.devices()[:world])
    cfg = JCfg(vocab_size=64, max_len=SEQ, num_layers=1, d_model=32,
               num_heads=2, d_ff=64, dtype=jnp.float32)
    params0 = jinit(jax.random.PRNGKey(0), cfg)
    su = jwu.ShardedUpdate(JAdam(lr=1e-2, impl="fused"), axis_name="data",
                           collective_scheme=scheme)
    vma_kw = {} if has_vma() else {"check_vma": False}
    pspec = jax.tree_util.tree_map(lambda _: JP(), params0)
    sspec = su.state_pspecs(params0, world)

    def grads_of(params, tokens):
        pv = jax.tree_util.tree_map(lambda p: _to_varying(p, ("data",)),
                                    params)
        return jax.value_and_grad(lambda p: jloss(
            p, {"tokens": tokens, "targets": tokens}, cfg))(pv)

    @functools.partial(jshard_map, mesh=mesh, in_specs=(pspec,),
                       out_specs=(sspec, JP("data")))
    def init_s(p):
        return su.init(p), su.init_residual(p)[None]

    def body(params, state, res, tokens):
        loss, grads = grads_of(params, tokens)
        params, state, r2 = su.step(state, grads, params, residual=res[0])
        return params, state, r2[None], jax.lax.pmean(loss, "data")

    jstep = jax.jit(jshard_map(
        body, mesh=mesh, in_specs=(pspec, sspec, JP("data"), JP("data")),
        out_specs=(pspec, sspec, JP("data"), JP()), **vma_kw))
    state0, res0 = jax.jit(init_s)(params0)

    def step_fn(state, batch):
        params, opt_state, res = state
        params, opt_state, res, loss = jstep(params, opt_state, res, batch)
        return (params, opt_state, res), loss

    return (params0, state0, res0), step_fn, su.layout_meta(params0, world)


def _jax_batch(step):
    rng = np.random.RandomState(1000 + step)
    return jnp.asarray(rng.randint(0, 64, (8, SEQ)).astype("int32"))


def _jax_fp32_trajectory(d):
    """The JAX harness at fp32: world 4 killed by resize@6:2, resumed at
    world 2 through elastic; the losses of both runs, in step order."""
    losses = []
    st4, step4, lay4 = _jax_harness(4, "fp32")
    gc = lambda w, lay: JGuardConfig(  # noqa: E731
        ckpt_dir=str(d), save_every_steps=2, check_every=2,
        backoff_seconds=0.01, enabled=True, world_size=w,
        ckpt_meta={"plan": {"dp": w}, "layout": lay})
    JTrainGuard(step4, gc(4, lay4), plan=jfaults.parse("resize@6:2"),
                on_check=lambda s, ls: losses.extend(ls)).run(
        st4, _jax_batch, 10)
    st2, step2, lay2 = _jax_harness(2, "fp32")
    JTrainGuard(step2, gc(2, lay2), elastic=jelastic.ElasticResume(),
                on_check=lambda s, ls: losses.extend(ls)).run(
        st2, _jax_batch, 10)
    return losses, jax.tree_util.tree_map(np.asarray, st4[0])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawned runs, once for the module: world 4 (int8 and fp32,
    resize@6:2), world 2 (the resumes, the independent import, the grow
    run killed by resize@5:4), world 4 (the grown resume and its import);
    the world-4 checkpoints' shapes read between the spawns."""
    tmp = tmp_path_factory.mktemp("elastic_ranks")
    jlosses, params_np = _jax_fp32_trajectory(tmp / "jax")
    d = {k: str(tmp / k) for k in ("a", "f", "g")}
    out = {"jax_losses": jlosses}
    out["w4"] = _torch_dist.run_ranks(
        _torch_dist.elastic_guard_cases, 4, tmp, params_np, CFG_KW, [
            dict(name="int8", mode="guard", scheme=INT8, dir=d["a"],
                 steps=10, plan="resize@6:2"),
            dict(name="fp32", mode="guard", scheme="fp32", dir=d["f"],
                 steps=10, plan="resize@6:2")])
    out["ckpt4"] = CheckpointManager(d["a"]).load_latest(with_meta=True)
    out["w2"] = _torch_dist.run_ranks(
        _torch_dist.elastic_guard_cases, 2, tmp, params_np, CFG_KW, [
            dict(name="no_elastic", mode="guard", scheme=INT8, dir=d["a"],
                 steps=10),
            dict(name="import", mode="import", scheme=INT8, dir=d["a"],
                 steps=10),
            dict(name="elastic", mode="guard", scheme=INT8, dir=d["a"],
                 steps=10, elastic=TINY_PROFILE),
            dict(name="fp32", mode="guard", scheme="fp32", dir=d["f"],
                 steps=10, elastic=TINY_PROFILE),
            dict(name="grow_start", mode="guard", scheme=INT8, dir=d["g"],
                 steps=10, plan="resize@5:4"),
            dict(name="grow_clean", mode="import", scheme=INT8,
                 dir=d["g"], steps=10)])
    out["g4"] = _torch_dist.run_ranks(
        _torch_dist.elastic_guard_cases, 4, tmp, params_np, CFG_KW, [
            dict(name="import", mode="import", scheme=INT8, dir=d["g"],
                 steps=10),
            dict(name="elastic", mode="guard", scheme=INT8, dir=d["g"],
                 steps=10, elastic=TINY_PROFILE)])
    out["sub"] = _torch_dist.run_ranks(
        _torch_dist.elastic_subgroup_cases, 4, tmp, params_np, CFG_KW, INT8,
        str(tmp / "sub"))
    return out


def test_world4_payload_is_the_jax_layout(ranks):
    ck_step, payload, meta = ranks["ckpt4"]
    lay = ranks["w4"][0]["int8"]["layout"]
    assert ck_step == 6 and meta["world_size"] == 4
    assert meta["layout"] == lay and meta["plan"] == {"dp": 4}
    assert lay["flat_total"] != ranks["w2"][0]["import"]["layout"][
        "flat_total"]                                  # a real re-chunk
    shapes = [np.shape(h) for h in payload["leaves"]]
    tot = lay["flat_total"]
    # the tail of the leaf list: count, m, v, master, then the residual
    assert shapes[-5:] == [(), (tot,), (tot,), (tot,), (4, tot)]
    res = np.asarray(payload["leaves"][-1])
    assert all(np.any(res[r]) for r in range(4))       # per-rank residuals
    rep = ranks["w4"][0]["int8"]["report"]
    assert rep["status"] == "preempted" and rep["resize_to"] == 2


def test_resume_without_elastic_raises_naming_both_worlds(ranks):
    for r in ranks["w2"]:
        e = r["no_elastic"]
        assert (e["saved"], e["live"]) == (4, 2)
        assert "world size 4" in e["error"] and "world size 2" in e["error"]


def test_resize_4_to_2_is_bitwise_the_clean_import(ranks):
    for r in ranks["w2"]:
        a, b = r["elastic"], r["import"]
        assert a["report"]["resharded_from"] == 4
        assert a["report"]["resumed_from"] == 6 and b["resumed_from"] == 6
        assert a["report"]["status"] == "completed"
        assert len(a["state"]) == len(b["state"])
        for x, y in zip(a["state"], b["state"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert a["plan"]["dp"] == 2                  # re-planned at 2 chips
    assert np.any(ranks["w2"][0]["elastic"]["state"][-1])   # EF live


def test_elastic_events_and_reads(ranks):
    ev = dict(ranks["w2"][0]["elastic"]["events"])
    assert ev["elastic.reshard"]["from_world"] == 4
    assert ev["elastic.reshard"]["to_world"] == 2
    assert ev["elastic.reshard"]["fields_resharded"] == 4
    assert ev["elastic.replan"]["chips"] == 2
    assert ev["elastic.replan"]["new_knobs"]["dp"] == 2
    for run in (ranks["w4"], ranks["w2"], ranks["g4"]):
        for r in run:
            for case in r.values():
                if "reads" not in case:
                    continue
                reads, checks, ckpts, gathers = case["reads"]
                assert reads == checks + ckpts
                assert gathers == 2 * ckpts         # shards, then the stack


def test_grow_2_to_4(ranks):
    for r in ranks["w2"]:
        assert r["grow_start"]["report"]["resize_to"] == 4
    for rank, r in enumerate(ranks["g4"]):
        a, c = r["elastic"], r["import"]
        assert a["report"]["resharded_from"] == 2
        for x, y in zip(a["state"], c["state"]):
            np.testing.assert_array_equal(x, y)      # bitwise the import
        d = ranks["w2"][rank % 2]["grow_clean"]
        # parameters (replicated) against the clean world-2 continuation
        n_params = len(a["state"]) - 5
        for x, y in zip(a["state"][:n_params], d["state"][:n_params]):
            np.testing.assert_allclose(x, y, rtol=0.25, atol=2e-2)


def test_data_subgroup_snapshots_and_resumes_over_its_group(ranks):
    """Data groups {0,1} and {2,3} of a world of 4, each with its own
    checkpoints: a snapshot gathers over the data group (the flat leaves
    have the group's ``flat_total``, the residual stack its two rows), the
    preempt + resume ends bitwise on the uninterrupted run on every rank,
    and a guard left on the default group refuses the layout."""
    for rank, r in enumerate(ranks["sub"]):
        tot = r["layout"]["flat_total"]
        assert r["saved_shapes"] == [(tot,), (tot,), (tot,), (2, tot)]
        assert r["preempted"] == "preempted" and r["status"] == "completed"
        assert r["resumed_from"] == 5          # the preemption's save
        reads, checks, ckpts, gathers = r["reads"]
        assert reads == checks + ckpts and gathers == 2 * ckpts
        for x, y in zip(r["clean"], r["resumed"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert "shard_group" in r["nogroup_error"]
        # the two data groups ran the same data: the same end state
        for x, y in zip(r["clean"], ranks["sub"][rank % 2]["clean"]):
            np.testing.assert_array_equal(x, y)
    assert np.any(ranks["sub"][0]["clean"][-1])          # EF live


def test_resumed_fp32_losses_track_the_jax_harness(ranks):
    port = ranks["w4"][0]["fp32"]["losses"] + \
        ranks["w2"][0]["fp32"]["losses"]
    jax_losses = ranks["jax_losses"]
    assert len(port) == len(jax_losses) == 10
    np.testing.assert_allclose(port, jax_losses, rtol=TRAJ_RTOL)
    assert ranks["w2"][0]["fp32"]["report"]["resharded_from"] == 4
