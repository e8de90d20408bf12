"""The port's plan step engine, plans, named mesh and launcher against the
JAX package's ``parallel.spmd`` / ``plan`` / ``mesh``.

Engines, 6 steps of the flagship stand-in (``_flagship_cfg(False)``: 2
layers, width 128, sequence 64) at global batch 8, from the JAX weights,
on spawned gloo ranks (``tests/_torch_parallel.py``); the JAX side on the
conftest's CPU devices (``Plan.apply(devices=jax.devices()[:W])``):

- step 0's loss within 1e-5 relative of the reference's, then every step
  within the JAX tests' ``_assert_fp32_tolerance`` (2e-2 relative or
  5e-3), and the loss falls;
- references: sp-ulysses (dp 2 x sp 2) and zero (dp 2) against the JAX
  engines of the same shape; sp-ring (dp 2 x sp 2) and pp (dp 2 x pp 2,
  M 2) against the JAX dp oracle ``Plan(dp=W)`` (the JAX engines of those
  two fail their own tests: a type error and a step-1 miss); ep (dp 2 x
  ep 2) against the JAX dp-MoE twin on a data-only mesh of the same world
  (the same tokens per device, so the same capacity);
- the pp engine's step-0 gradients (pp 2, dp 1) within 2e-5 absolute of
  the dense oracle's (``jax.grad`` of ``transformer_loss`` on the whole
  batch): every loss term is counted once;
- the sp and pp meters equal JAX's ``_sp_schedule_bytes`` /
  ``_pp_schedule_bytes``; the ep exchanges metered over one executed step
  equal ``_ep_schedule_bytes``;
- the tp family (Megatron splits): dp1 x tp2 (world 2), dp2 x tp2 and
  dp1 x tp4 (world 4), and dp2 x tp2 with zero1, against the JAX tp
  engine (GSPMD) at dp2 x tp2 on 4 CPU devices; after one step the
  gathered shards equal the port's dp engine's parameters within 1e-5 of
  each leaf's peak; with ``amp_dtype="bfloat16"`` the master stays fp32
  and the losses, finite and falling, stay within 2e-2 relative of JAX's
  bf16 run; ``tp.psum`` meters the executed tape once, and its layer
  all-reduces are the cost model's ``4 L`` activation payload;
- ``build_plan_step(Plan(dp=2))`` is bit-equal to ``train.
  build_flagship_step``, and so is a zero1 plan's int8 parameter
  all-gather to the flagship step with those DDP knobs; a tp plan builds
  and trains there too; ``train.flat_update``'s chunks are one
  ``step_flat``, bit for bit.

Plans: ``family`` / ``measurable`` / ``axis_sizes`` / ``knobs`` / ``env``
/ ``describe`` / ``complexity`` as JAX's, every JAX name but
``from_tuning``; ``Plan.apply`` sets and restores the environment and
``Plan.pspecs`` gives the Megatron specs at tp > 1.
The mesh: row-major layout, one group per axis, axis names resolving
through the ambient mesh, ``Placement`` blocks.  The launcher runs a
2-rank gloo all-reduce script.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apex_tpu.models import transformer_init as jtransformer_init
from apex_tpu.models import transformer_loss as jtransformer_loss
from apex_tpu.models.moe_transformer import moe_transformer_init as jmoe_init
from apex_tpu.parallel import collectives as jcoll
from apex_tpu.parallel import plan as jplan
from apex_tpu.parallel import spmd as jspmd
from apex_tpu.parallel import weight_update as jwu

from apex_tpu_torch.parallel import Plan, default_plan, plan as pplan
from apex_tpu_torch.parallel import spmd as pspmd

import _torch_dist
import _torch_parallel

GB = 8
STEPS = 6
CFG = jplan._flagship_cfg(False)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env():
    saved = {k: os.environ.pop(k, None)
             for k in (jcoll.ENV_KNOB, jwu.ENV_KNOB, "APEX_TPU_OVERLAP")}
    yield
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


def _tokens():
    rng = np.random.RandomState(0)
    return rng.randint(0, CFG.vocab_size, (GB, CFG.max_len)).astype("int32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_losses(plan, world, build=None, **kw):
    toks = jnp.asarray(_tokens())
    with plan.apply(devices=jax.devices()[:world]) as mesh:
        if build is None:
            carry, step, _ = jspmd.build_plan_step(CFG, mesh, plan,
                                                   global_batch=GB,
                                                   meter=False, **kw)
        else:
            carry, step, _ = build(mesh)
        losses = []
        for _ in range(STEPS):
            carry, loss = step(carry, toks)
            losses.append(float(loss))
    return losses


def _assert_fp32_tolerance(losses, baseline):
    assert losses[-1] < losses[0]
    for i, (a, b) in enumerate(zip(losses, baseline)):
        assert abs(a - b) <= max(2e-2 * abs(b), 5e-3), \
            f"step {i}: {a} vs reference {b}"
    assert abs(losses[0] - baseline[0]) <= 1e-5 * abs(baseline[0])


W4_CASES = {
    "sp-ring": {"plan": dict(dp=2, sp=2, sp_strategy="ring")},
    "sp-ulysses": {"plan": dict(dp=2, sp=2, sp_strategy="ulysses")},
    "pp": {"plan": dict(dp=2, pp_stages=2, pp_microbatches=2)},
    "ep": {"plan": dict(dp=2, ep=2)},
    "tp-dp2": {"plan": dict(dp=2, tp=2), "step1_params": True},
    "tp-dp1": {"plan": dict(dp=1, tp=4)},
    "tp-zero1": {"plan": dict(dp=2, tp=2, update_sharding="zero1")},
    "tp-bf16": {"plan": dict(dp=2, tp=2), "amp_dtype": "bfloat16",
                "meter": False},
    "dp": {"plan": dict(dp=4), "step1_params": True, "meter": False},
}
W2_CASES = {
    "zero": {"plan": dict(dp=2, zero=True)},
    "pp-grads": {"plan": dict(dp=1, pp_stages=2, pp_microbatches=2),
                 "grads": True},
    "tp-dp1": {"plan": dict(dp=1, tp=2)},
}


@pytest.fixture(scope="module")
def weights():
    params = _np(jtransformer_init(jax.random.PRNGKey(0), CFG))
    moe = _np(jmoe_init(jax.random.PRNGKey(0),
                        jspmd._moe_cfg_from(CFG, 1)))
    return params, moe


@pytest.fixture(scope="module")
def world4(weights, tmp_path_factory):
    params, moe = weights
    return _torch_dist.run_ranks(
        _torch_parallel.spmd_engine_cases, 4, tmp_path_factory.mktemp("w4"),
        W4_CASES, _tokens(), params, moe, STEPS, deadline_s=240.0)


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    params, moe = weights
    return _torch_dist.run_ranks(
        _torch_parallel.spmd_engine_cases, 2, tmp_path_factory.mktemp("w2"),
        W2_CASES, _tokens(), params, moe, STEPS)


@pytest.fixture(scope="module")
def dp4_oracle():
    return _jax_losses(jplan.Plan(dp=4), 4)


def _same_on_every_rank(ranks, name):
    losses = ranks[0][name]["losses"]
    for r in ranks[1:]:
        assert r[name]["losses"] == losses
    return losses


@pytest.mark.parametrize("name", ["sp-ring", "pp"])
def test_engine_trains_to_the_dp_oracle(world4, dp4_oracle, name):
    losses = _same_on_every_rank(world4, name)
    _assert_fp32_tolerance(losses, dp4_oracle)


def test_pp_tracks_the_dense_oracle_not_the_jax_pp_engine(world4,
                                                          dp4_oracle):
    """The JAX pp engine of the same shape misses its own test from step
    1 on; the port's pp engine, whose step-0 gradients are the dense
    oracle's (below), stays nearer the dp oracle at every later step."""
    port = _same_on_every_rank(world4, "pp")
    jax_pp = _jax_losses(jplan.Plan(dp=2, pp_stages=2, pp_microbatches=2),
                         4)
    print("pp losses: port", port, "jax pp engine", jax_pp, "dp oracle",
          dp4_oracle)
    for i in range(1, STEPS):
        assert abs(port[i] - dp4_oracle[i]) < abs(jax_pp[i] -
                                                  dp4_oracle[i]), i


def test_sp_ulysses_matches_the_jax_engine(world4):
    ref = _jax_losses(jplan.Plan(dp=2, sp=2, sp_strategy="ulysses"), 4)
    _assert_fp32_tolerance(_same_on_every_rank(world4, "sp-ulysses"), ref)


def test_ep_matches_the_jax_dp_moe_twin(world4):
    def twin(mesh):
        return jspmd._build_ep_step(CFG, mesh, jplan.Plan(dp=4), GB, 1e-2,
                                    False)
    ref = _jax_losses(jplan.Plan(dp=4), 4, build=twin)
    _assert_fp32_tolerance(_same_on_every_rank(world4, "ep"), ref)


def test_zero_matches_the_jax_engine(world2):
    ref = _jax_losses(jplan.Plan(dp=2, zero=True), 2)
    _assert_fp32_tolerance(_same_on_every_rank(world2, "zero"), ref)


def test_pp_gradients_match_the_dense_oracle(world2, weights):
    params, _ = weights
    toks = jnp.asarray(_tokens())
    loss, g = jax.value_and_grad(lambda p: jtransformer_loss(
        p, {"tokens": toks, "targets": toks}, CFG))(
            jax.tree_util.tree_map(jnp.asarray, params))
    g = _np(g)
    half = CFG.num_layers // 2
    for stage, r in enumerate(world2):
        ploss, pg = r["pp-grads"]["grads"]
        assert abs(ploss - float(loss)) <= 1e-5 * abs(float(loss))
        for grp in ("embed", "head"):
            for k, v in g[grp].items():
                np.testing.assert_allclose(pg[grp][k], v, atol=2e-5,
                                           err_msg=f"{grp}.{k}")
        for k, v in g["layers"].items():
            np.testing.assert_allclose(
                pg["layers"][k], v[stage * half:(stage + 1) * half],
                atol=2e-5, err_msg=f"layers.{k} stage {stage}")


def test_sp_and_pp_meters_equal_the_jax_schedules(world4):
    r = world4[0]
    for name, strategy in (("sp-ring", "ring"), ("sp-ulysses", "ulysses")):
        want = jspmd._sp_schedule_bytes(CFG, strategy, 2, 2, GB)
        assert r[name]["info"]["sp_wire"] == want
        assert pspmd._sp_schedule_bytes(pplan._flagship_cfg(False), strategy,
                                        2, 2, GB) == want
        op = "all_to_all" if strategy == "ulysses" else "ppermute"
        assert r[name]["meters"][f"sp.{op}_bytes"] == want["logical_bytes"]
    want = jspmd._pp_schedule_bytes(CFG, 2, 2, 2, GB)
    assert r["pp"]["info"]["pp_wire"] == want
    assert r["pp"]["meters"]["pp.ppermute_bytes"] == want["logical_bytes"]
    assert r["pp"]["info"]["pipeline_bubble_fraction"] == pytest.approx(1 / 3)
    assert r["pp"]["info"]["stages_layers"] == CFG.num_layers // 2


def test_ep_meter_of_one_step_equals_the_jax_schedule(world4):
    moe_cfg = jspmd._moe_cfg_from(CFG, 2)
    want = jspmd._ep_schedule_bytes(moe_cfg, 2, 2, GB)
    for r in world4:
        info = r["ep"]["info"]
        assert info["ep_wire"] == want
        assert info["experts"] == jplan.EP_DEFAULT_EXPERTS
        assert r["ep"]["meters"]["ep.all_to_all_bytes"] == \
            want["logical_bytes"]
        assert info["metered"]["all-to-all"]["logical_bytes"] == \
            want["logical_bytes"]
        assert info["metered"]["all-to-all"]["count"] == \
            4 * moe_cfg.num_layers


def test_engine_info_keeps_the_jax_keys(world4, world2):
    for name in W4_CASES:
        info = world4[0][name]["info"]
        assert info["family"] == Plan(**W4_CASES[name]["plan"]).family
        assert ("collectives" in info) == W4_CASES[name].get("meter", True)
    assert world4[0]["sp-ring"]["info"]["engine"] == "shard_map.sp.ring"
    assert world4[0]["pp"]["info"]["engine"] == "shard_map.pp"
    assert world2[0]["zero"]["info"]["engine"] == "shard_map.zero"
    # the ring's rotations (forward n a layer for k and v; the backward
    # skips the last, whose output nothing reads)
    ring = world4[0]["sp-ring"]["info"]["collectives"]["collective-permute"]
    assert ring["count"] == CFG.num_layers * (2 * 2 + 2 * 1)


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX tp engine (GSPMD) at dp2 x tp2 on 4 CPU devices."""
    return _jax_losses(jplan.Plan(dp=2, tp=2), 4)


@pytest.mark.parametrize("world,name", [(2, "tp-dp1"), (4, "tp-dp2"),
                                        (4, "tp-dp1"), (4, "tp-zero1")])
def test_tp_matches_the_jax_tp_engine(world4, world2, jax_tp, world, name):
    ranks = world4 if world == 4 else world2
    losses = _same_on_every_rank(ranks, name)
    print(f"tp {name} at world {world}: port {losses}, jax {jax_tp}, "
          f"step errors {[abs(a - b) for a, b in zip(losses, jax_tp)]}")
    _assert_fp32_tolerance(losses, jax_tp)
    info = ranks[0][name]["info"]
    plan = Plan(**(W4_CASES if world == 4 else W2_CASES)[name]["plan"])
    assert info["engine"] == "megatron" and info["family"] == "tp"
    assert (info["tp"], info["dp"]) == (plan.tp, plan.dp)
    assert info["flat_world"] == plan.tp * (plan.dp if plan.shards_update
                                            else 1)
    assert info["amp_dtype"] is None
    assert ranks[0][name]["master_dtype"] == "torch.float32"


def test_tp_shards_after_one_step_are_the_dp_engine_parameters(world4,
                                                                weights):
    """The dp2 x tp2 ranks' shards after one step, gathered over the model
    axis (ranks 0, 1 and 2, 3 are the two data replicas), equal the dp4
    engine's parameters within 1e-5 of each leaf's peak wherever the
    step's gradient is at least 100 x Adam's eps: Adam's first update is
    lr g / (|g| + eps), which turns the ~1e-10 that two reduction orders
    leave on a gradient of ~eps into ~lr / 4 (a few dozen elements of
    each matrix); those stay within 2 lr."""
    import torch
    from apex_tpu_torch.models import tp_gather_params
    from apex_tpu_torch.parallel.plan import _flagship_cfg
    params, _ = weights
    toks = jnp.asarray(_tokens())
    g = jax.grad(lambda p: jtransformer_loss(
        p, {"tokens": toks, "targets": toks}, CFG))(
            jax.tree_util.tree_map(jnp.asarray, params))
    cfg = _flagship_cfg(False)
    want = jax.tree_util.tree_leaves(world4[0]["dp"]["step1_params"])
    lr, eps = 1e-2, 1e-8
    for replica in (world4[:2], world4[2:]):
        got = tp_gather_params([jax.tree_util.tree_map(
            torch.from_numpy, r["tp-dp2"]["step1_params"])
            for r in replica], cfg)
        got = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), got))
        for a, b, gl in zip(got, want, jax.tree_util.tree_leaves(_np(g))):
            err = np.abs(a - b)
            live = np.abs(gl) >= 100 * eps
            assert err[live].max(initial=0.0) <= 1e-5 * np.abs(b).max()
            assert err.max() <= 2 * lr


def test_tp_bf16_model_copy_over_the_fp32_master(world4):
    """``amp_dtype="bfloat16"``: the master stays fp32, the losses are
    finite and fall, and each is within 2e-2 relative of the JAX engine's
    bf16 run (bf16 activations round each product to 8 bits of
    mantissa; the two engines order their reductions differently)."""
    ref = _jax_losses(jplan.Plan(dp=2, tp=2), 4, amp_dtype="bfloat16")
    losses = _same_on_every_rank(world4, "tp-bf16")
    print("tp bf16: port", losses, "jax", ref)
    assert world4[0]["tp-bf16"]["master_dtype"] == "torch.float32"
    assert world4[0]["tp-bf16"]["info"]["amp_dtype"] == "bfloat16"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for a, b in zip(losses, ref):
        assert abs(a - b) <= 2e-2 * abs(b), (losses, ref)


def test_tp_meter_is_the_executed_tape(world4, world2):
    """``tp.psum`` records the first step's all-reduce tape once; the tape
    is the static Megatron schedule: 4 activation blocks a layer (the
    cost model's ``t_tp`` payload, ``4 L act_layer_bytes / dp``), one for
    the embedding's lookup and one for the head's input cotangent, and
    the cross-entropy's three fp32 rows."""
    S, D, L = CFG.max_len, CFG.d_model, CFG.num_layers
    prof = pplan.ModelProfile(
        name="t", flops=1.0, bytes_accessed=1.0, params_bytes=0,
        optimizer_bytes=0, activations_bytes=0, batch_bytes=0,
        temps_bytes=0, output_bytes=0, layers=L,
        act_layer_bytes=GB * S * D * 4)
    for ranks, name, dp in ((world4, "tp-dp2", 2), (world4, "tp-dp1", 1),
                            (world2, "tp-dp1", 1)):
        for r in ranks:
            res = r[name]
            tape = res["info"]["collectives"]["all-reduce"]
            assert res["meters"]["tp.psum_bytes"] == tape["logical_bytes"]
            assert res["meters"]["tp.psum_calls"] == 1
            assert res["info"]["metered"]["all-reduce"] == tape
            rows = GB // dp * S
            parts = res["info"]["tp_wire"]["parts"]
            assert parts["layers"] == 4 * L * rows * D * 4
            assert parts["layers"] == 4 * prof.layers * \
                prof.act_layer_bytes // dp
            assert parts == {"layers": 4 * L * rows * D * 4,
                             "embed": rows * D * 4, "head": rows * D * 4,
                             "xent": 3 * rows * 4}
            assert tape["logical_bytes"] == sum(parts.values())
            assert tape["count"] == 4 * L + 2 + 3


@pytest.fixture(scope="module")
def flagship_pairs(weights, tmp_path_factory):
    params, _ = weights
    return _torch_dist.run_ranks(_torch_parallel.flagship_pair, 2,
                                 tmp_path_factory.mktemp("pair"), _tokens(),
                                 params, 3)


def test_dp_plan_is_bit_equal_to_the_flagship_step(flagship_pairs):
    for r in flagship_pairs:
        pl, pp, info = r["plan"]
        fl, fp = r["flagship"]
        assert pl == fl and info["family"] == "dp"
        assert info["overlap"] == "off"
        for a, b in zip(jax.tree_util.tree_leaves(pp),
                        jax.tree_util.tree_leaves(fp)):
            np.testing.assert_array_equal(a, b)
        tl, engine, tp = r["tp_plan"]
        assert engine == "megatron" and tp == 2
        assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def test_plan_allgather_scheme_reaches_the_sharded_update(flagship_pairs):
    """A zero1 plan's ``allgather_scheme`` is the step's: the plan step is
    bit-equal to ``build_flagship_step`` with the same DDP knobs, and the
    int8 all-gather's parameters differ from the fp32 one's; without a
    sharded update the scheme is refused."""
    for r in flagship_pairs:
        (al, ap), (fl, fp) = r["ag_plan"], r["ag_flagship"]
        assert al == fl
        for a, b in zip(jax.tree_util.tree_leaves(ap),
                        jax.tree_util.tree_leaves(fp)):
            np.testing.assert_array_equal(a, b)
        zp = r["zero1_plan"][1]
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(ap), jax.tree_util.tree_leaves(zp)))
        assert "sharded update" in r["ag_error"]


@pytest.mark.parametrize("knobs", [
    dict(dp=8), dict(dp=4, tp=2), dict(dp=4, sp=2, sp_strategy="ring"),
    dict(dp=2, pp_stages=2, pp_microbatches=4), dict(dp=4, ep=2),
    dict(dp=8, zero=True), dict(dp=4, update_sharding="zero1",
                                collective_scheme="bf16",
                                allgather_scheme="int8_blockscale")])
def test_plan_surface_matches_jax(knobs):
    j, p = jplan.Plan(**knobs), Plan(**knobs)
    for attr in ("family", "chips", "shards_update", "complexity"):
        assert getattr(p, attr) == getattr(j, attr), attr
    # every family has an engine in both packages
    assert j.measurable and p.measurable
    assert p.axis_sizes() == j.axis_sizes()
    assert p.knobs() == j.knobs()
    assert p.env() == j.env()
    assert p.describe() == j.describe()
    assert default_plan(8) == Plan(dp=8)
    assert pplan.EP_DEFAULT_EXPERTS == jplan.EP_DEFAULT_EXPERTS


#: JAX ``parallel.plan`` names the port leaves out, with the reason:
#: ``from_tuning`` reads a tuning profile, which the port does not have
#: (ROADMAP.md, Queue 1 item 11); ``build_flagship_step`` is
#: ``apex_tpu_torch.train``'s
PLAN_NO_COUNTERPART = {"from_tuning", "build_flagship_step"}
PLAN_FIELDS_NO_COUNTERPART = set()


def test_every_jax_plan_name_has_a_counterpart():
    """Each name of the JAX plan module's ``__all__`` and each ``Plan``
    field exists in the port, apart from the listed names, which the port
    must not carry unread."""
    import dataclasses
    from apex_tpu_torch import train
    assert PLAN_NO_COUNTERPART <= set(jplan.__all__)
    missing = [n for n in jplan.__all__
               if n not in PLAN_NO_COUNTERPART and not hasattr(pplan, n)]
    assert not missing, missing
    assert not any(hasattr(pplan, n) for n in PLAN_NO_COUNTERPART)
    assert callable(train.build_flagship_step)
    jf = {f.name for f in dataclasses.fields(jplan.Plan)}
    pf = {f.name for f in dataclasses.fields(Plan)}
    assert jf - pf == PLAN_FIELDS_NO_COUNTERPART and pf <= jf


@pytest.mark.parametrize("n,chunk", [(1000, 7), (1000, 1000), (1024, 128)])
def test_flat_update_chunks_are_bit_equal_to_one_step(monkeypatch, n,
                                                      chunk):
    """``train.flat_update`` over chunks of ``UPDATE_CHUNK`` elements is
    one ``step_flat`` over the whole buffers, bit for bit, with the
    overflow select; a non-finite gradient leaves the state as it was."""
    import torch
    from apex_tpu_torch import train
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.pytree import tree_leaves
    gen = torch.Generator().manual_seed(n + chunk)
    params = {"a": torch.randn(n - 24, generator=gen),
              "b": torch.randn(4, 6, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    opt = FusedAdam(lr=1e-2, impl="fused")
    state = opt.init(params)
    state = opt.step_flat(state, opt.flattener_for(params).flatten(grads))
    flat = opt.flattener_for(params).flatten(grads)
    want = opt.step_flat(state, flat)
    monkeypatch.setattr(train, "UPDATE_CHUNK", chunk)
    new_params, got = train.flat_update(opt, state, params, [grads])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    wp = opt.flattener_for(params).unflatten(want.master, like=params)
    for a, b in zip(tree_leaves(new_params), tree_leaves(wp)):
        assert torch.equal(a, b)
    bad = {"a": grads["a"].clone(), "b": grads["b"]}
    bad["a"][-1] = float("inf")
    _, kept = train.flat_update(opt, state, params, [bad])
    for a, b in zip(kept, state):
        assert torch.equal(a, b)


def _apply_env(rank, world):
    from apex_tpu_torch.parallel import Plan, current_mesh
    from apex_tpu_torch.parallel import collectives, weight_update
    from apex_tpu_torch.parallel.plan import _flagship_cfg
    seen = []
    os.environ[collectives.ENV_KNOB] = "bf16"
    with Plan(dp=1, update_sharding="zero1").apply() as mesh:
        seen.append((os.environ.get(weight_update.ENV_KNOB),
                     collectives.ENV_KNOB in os.environ,
                     current_mesh() is mesh, dict(mesh.shape)))
    seen.append((os.environ.get(collectives.ENV_KNOB),
                 weight_update.ENV_KNOB in os.environ,
                 current_mesh() is None))
    with Plan(dp=1, collective_scheme="int8_blockscale").apply():
        seen.append(os.environ[collectives.ENV_KNOB])
    seen.append(os.environ.get(collectives.ENV_KNOB))
    specs = Plan(dp=1).pspecs(_flagship_cfg(False))
    seen.append(sorted(specs["layers"].values()) ==
                ["replicated"] * len(specs["layers"]))
    from apex_tpu_torch.models import transformer_pspecs
    seen.append(Plan(tp=2).pspecs(_flagship_cfg(False))
                == transformer_pspecs(_flagship_cfg(False)))
    return seen


def test_plan_apply_sets_and_restores_the_environment(tmp_path):
    seen = _torch_dist.run_in_process(_apply_env, tmp_path)
    assert seen[0] == ("zero1", False, True, {"data": 1})
    assert seen[1] == ("bf16", False, True)
    assert seen[2] == "int8_blockscale"
    assert seen[3] == "bf16"
    assert seen[4] is True and seen[5] is True


def test_mesh_layout_groups_and_placements(tmp_path):
    ranks = _torch_dist.run_ranks(_torch_parallel.mesh_cases, 4, tmp_path)
    g = np.arange(24).reshape(4, 6)
    for rank, r in enumerate(ranks):
        d, s = divmod(rank, 2)            # JAX's devices.reshape(2, 2)
        assert r["shape"] == {"data": 2, "seq": 2}
        assert r["coords"] == {"data": d, "seq": s}
        assert r["members"] == {"data": [s, 2 + s], "seq": [2 * d, 2 * d + 1]}
        assert r["bound"] == (True, True, False, ("seq", "data"))
        assert r["sizes"] == (2, 1, 2)
        assert r["sums"] == {"data": float(s + 2 + s),
                             "seq": float(4 * d + 1)}
        blk, data_blk, rep, flat = r["local"]
        np.testing.assert_array_equal(blk, g[2 * d:2 * d + 2,
                                             3 * s:3 * s + 3])
        np.testing.assert_array_equal(data_blk, g[2 * d:2 * d + 2])
        np.testing.assert_array_equal(rep, g)
        np.testing.assert_array_equal(flat, g[rank:rank + 1])
        assert "unbound axis name: 'pipe'" in r["unbound"]
        assert r["no_mesh"] is True
        assert r["slices"] == 1
        assert "mesh {'data': 3} != 4 devices" in r["bad"]


def test_launcher_runs_a_gloo_all_reduce(tmp_path):
    script = tmp_path / "allreduce.py"
    script.write_text(
        "import sys, torch, torch.distributed as dist\n"
        "from apex_tpu_torch.parallel import initialize_distributed\n"
        "initialize_distributed(device='cpu')\n"
        "t = torch.tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "import os\n"
        "out = os.path.join(os.path.dirname(__file__), 'rank' +\n"
        "                   os.environ['RANK'])\n"
        "with open(out, 'w') as f:\n"
        "    print('rank', os.environ['RANK'], os.environ['LOCAL_RANK'],\n"
        "          os.environ['WORLD_SIZE'], float(t), sys.argv[1:],\n"
        "          file=f)\n"
        "dist.destroy_process_group()\n")
    env = {**os.environ, "PYTHONPATH": ROOT,
           "APEX_TPU_COORDINATOR_ADDRESS": "stale:1",
           "MASTER_PORT": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nproc_per_node", "2", str(script), "--flag", "x"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = [(tmp_path / f"rank{r}").read_text().strip() for r in (0, 1)]
    assert lines == ["rank 0 0 2 3.0 ['--flag', 'x']",
                     "rank 1 1 2 3.0 ['--flag', 'x']"]
    bad = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nnodes", "2", str(script)],
        capture_output=True, text=True, timeout=60, env=env, cwd=ROOT)
    assert bad.returncode != 0 and "--coordinator" in bad.stderr


def test_launcher_rank_environment():
    from apex_tpu_torch.parallel import multiproc
    import argparse
    args = argparse.Namespace(nnodes=2, node_rank=1, coordinator="h:29500")
    env = multiproc.rank_env(args, 1, 4, base={})
    assert env["RANK"] == "5" and env["WORLD_SIZE"] == "8"
    assert env["LOCAL_RANK"] == "1"
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("h", "29500")
    assert env["APEX_TPU_NUM_PROCESSES"] == "2"


def test_tree_walkers_keep_no_leaf_alive():
    """With the cyclic collector off, a leaf is freed as soon as the last
    tree holding it is dropped: the walkers make no reference cycle (a
    reduction of a gradient tree used to keep the tree and its flat buffer
    alive after returning)."""
    import gc
    import weakref
    import torch
    from apex_tpu_torch.parallel.distributed import allreduce_tree
    from apex_tpu_torch.utils import pytree
    tree = {"a": torch.ones(3), "b": [torch.ones(2), None]}
    ref = weakref.ref(tree["a"])
    was = gc.isenabled()
    gc.disable()
    try:
        leaves, td = pytree.tree_flatten(tree)
        outs = [pytree.tree_unflatten(td, leaves),
                pytree.tree_map(lambda x: x, tree),
                pytree.tree_map_with_path(lambda p, x: x, tree),
                pytree.tree_flatten_with_keystr(tree),
                allreduce_tree(tree)]          # no group: the identity
        del tree, leaves, outs
        assert ref() is None
    finally:
        if was:
            gc.enable()
