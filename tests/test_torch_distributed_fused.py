"""The port's ZeRO optimizers against the JAX package's.

The same numpy params and per-rank local gradients go to the JAX
``DistributedFusedAdam`` / ``DistributedFusedLAMB`` inside ``shard_map``
over as many CPU devices as the port has ranks (``check_vma=False`` for
``impl="fused"``, whose Pallas kernels run in interpret mode, as
``tests/L0/test_distributed_optimizers.py`` does), and to the port's on
gloo process groups: world 1 in this process, world 2 and the 2 x 2
two-level topology (``replica_group``) as spawned ranks
(``tests/_torch_dist.py``).  After three steps the new params and every
rank's p / m / v shard agree within 1e-5 (fp32 sums in other orders); with
bf16 moments, m and v within one bf16 step (2^-7 relative).  Both impls,
``bf16_allgather``, bf16 state, the overflow skip, loss-scale interop and
an LR schedule are covered.  The kernels themselves are held to their
plain versions on the card by ``tests/test_torch_cuda_kernels.py``.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.optimizers import DistributedFusedAdam as JaxAdam
from apex_tpu.contrib.optimizers import DistributedFusedLAMB as JaxLAMB
from apex_tpu.parallel.mesh import shard_map
from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry.registry import MemorySink as JMemorySink
from apex_tpu.telemetry.registry import Registry as JRegistry

import _torch_dist
from apex_tpu_torch.contrib.optimizers import (DistributedFusedLAMB,
                                               ShardedLAMBState,
                                               state_from_jax)
from apex_tpu_torch.parallel import collectives

SHAPES = {"p0": (33, 7), "p1": (128,), "p2": (3, 5, 11), "p3": (257,)}
ITERS = 3
TOL = 1e-5
BF16_RTOL = 2.0 ** -7

# name, optimizer, constructor kwargs, extras
CASES = [
    dict(name="lamb_xla", opt="lamb", kw=dict(lr=1e-2, impl="xla")),
    dict(name="lamb_fused", opt="lamb", kw=dict(lr=1e-2, impl="fused")),
    dict(name="adamw_xla_clip", opt="adam",
         kw=dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0,
                 impl="xla")),
    dict(name="adam_l2_fused", opt="adam",
         kw=dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False,
                 impl="fused")),
    dict(name="adam_fused_bf16_allgather", opt="adam",
         kw=dict(lr=1e-2, weight_decay=0.01, bf16_allgather=True,
                 impl="fused")),
    dict(name="lamb_fused_bf16_state", opt="lamb",
         kw=dict(lr=1e-2, impl="fused", state_dtype="bfloat16")),
    dict(name="adam_fused_overflow_skip", opt="adam",
         kw=dict(lr=1e-2, impl="fused"), poison_iter=1),
    dict(name="lamb_fused_schedule_scaled", opt="lamb",
         kw=dict(impl="fused"), lr="decay", grad_scale=64.0),
]
CASES_2X2 = [
    dict(name="adam_xla_2x2", opt="adam", topology="2x2",
         kw=dict(lr=1e-2, weight_decay=0.01, impl="xla")),
    dict(name="adam_fused_2x2", opt="adam", topology="2x2",
         kw=dict(lr=1e-2, weight_decay=0.01, impl="fused")),
]
CASES_WORLD1 = [CASES[1], CASES[3]]


def _params():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(n_ranks):
    rng = np.random.default_rng(100 + n_ranks)
    return [{k: rng.standard_normal((n_ranks,) + s).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(ITERS)]


def _jax_run(case, params_np, grads_np, n_ranks, iters=ITERS):
    """The JAX optimizer inside shard_map, as the JAX package's tests
    drive it; returns (params, global state), and the residual (world,
    total) after them for a case that threads one."""
    if case.get("residual"):
        return _jax_run_residual(case, params_np, grads_np, n_ranks)
    two_level = case.get("topology") == "2x2"
    devs = np.array(jax.devices()[:n_ranks])
    if two_level:
        mesh = Mesh(devs.reshape(2, 2), ("dcn", "ici"))
        axes, specs = dict(shard_axis="ici", replica_axis="dcn"), \
            P(("dcn", "ici"))
    else:
        mesh = Mesh(devs, ("data",))
        axes, specs = dict(shard_axis="data"), P("data")
    kw = dict(case["kw"])
    if kw.get("state_dtype") == "bfloat16":
        kw["state_dtype"] = jnp.bfloat16
    if "lr" in case:
        kw["lr"] = _torch_dist.LR_SCHEDULES[case["lr"]]
    opt = (JaxLAMB if case["opt"] == "lamb" else JaxAdam)(**axes, **kw)
    rep = {k: P() for k in params_np}
    sspec = opt.state_pspecs()
    vma_kw = {"check_vma": False} if opt.impl == "fused" else {}
    scale = case.get("grad_scale", 1.0)

    init = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(rep,),
                             out_specs=sspec))

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(sspec, {k: specs for k in params_np}, rep),
                       out_specs=(rep, sspec), **vma_kw)
    def step(state, grads_local, p):
        grads_local = {k: g[0] for k, g in grads_local.items()}
        return opt.step(state, grads_local, p, scale=scale)

    step = jax.jit(step)
    p = {k: jnp.asarray(v) for k, v in params_np.items()}
    state = init(p)
    for i, gl in enumerate(grads_np[:iters]):
        g = {k: jnp.asarray(v * scale) for k, v in gl.items()}
        if case.get("poison_iter") == i:
            g = {k: v.at[0].set(jnp.inf) for k, v in g.items()}
        p, state = step(state, g, p)
    return p, state


def _jax_run_residual(case, params_np, grads_np, n_ranks):
    """:func:`_jax_run` threading the int8 error-feedback residual, each
    device's in a (world, total) array; metered into a JAX registry."""
    mesh = Mesh(np.array(jax.devices()[:n_ranks]), ("data",))
    opt = (JaxLAMB if case["opt"] == "lamb" else JaxAdam)(
        shard_axis="data", **case["kw"])
    rep = {k: P() for k in params_np}
    sspec = opt.state_pspecs()
    vma_kw = {"check_vma": False} if opt.impl == "fused" else {}

    @functools.partial(shard_map, mesh=mesh, in_specs=(rep,),
                       out_specs=(sspec, P("data")), **vma_kw)
    def init(p):
        return opt.init(p), opt.init_residual(p)[None]

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(sspec, P("data"),
                                 {k: P("data") for k in params_np}, rep),
                       out_specs=(rep, sspec, P("data")), **vma_kw)
    def step(state, res, grads_local, p):
        grads_local = {k: g[0] for k, g in grads_local.items()}
        p, state, r = opt.step(state, grads_local, p, residual=res[0])
        return p, state, r[None]

    reg = JRegistry(sink=JMemorySink(), flush_interval=0, rank0_only=False)
    jevents.set_default(reg)
    try:
        p = {k: jnp.asarray(v) for k, v in params_np.items()}
        state, res = jax.jit(init)(p)
        step = jax.jit(step)
        for i, gl in enumerate(grads_np):
            g = {k: jnp.asarray(v) for k, v in gl.items()}
            if case.get("poison_iter") == i:
                g = {k: v.at[0].set(jnp.inf) for k, v in g.items()}
            p, state, res = step(state, res, g, p)
        meters = reg.read()
    finally:
        jevents.set_default(None)
    return p, state, np.asarray(res), meters


def _compare(case, port_ranks, j_params, j_state, n_shards):
    bf16 = case["kw"].get("state_dtype") == "bfloat16"
    total = np.asarray(j_state.p).shape[0]
    per = total // n_shards
    for rank, got in enumerate(port_ranks):
        for k in SHAPES:
            np.testing.assert_allclose(got["params"][k],
                                       np.asarray(j_params[k]), atol=TOL,
                                       rtol=0, err_msg=f"rank {rank} {k}")
        s = rank % n_shards
        sl = slice(s * per, (s + 1) * per)
        np.testing.assert_allclose(got["p"], np.asarray(j_state.p)[sl],
                                   atol=TOL, rtol=0, err_msg=f"rank {rank} p")
        for f in ("m", "v"):
            ref = np.asarray(j_state._asdict()[f]).astype(np.float32)[sl]
            np.testing.assert_allclose(
                got[f], ref, atol=TOL, rtol=BF16_RTOL if bf16 else 0,
                err_msg=f"rank {rank} {f}")
        assert got["m_dtype"] == ("torch.bfloat16" if bf16
                                  else "torch.float32")
        assert got["count"] == int(j_state.count)
        np.testing.assert_allclose(got["gnorm"], float(j_state.gnorm),
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _torch_dist.run_ranks(
        _torch_dist.zero_optimizer_cases, 2, tmp_path_factory.mktemp("zero"),
        CASES, _params(), _grads(2))


@pytest.fixture(scope="module")
def world2x2(tmp_path_factory):
    return _torch_dist.run_ranks(
        _torch_dist.zero_optimizer_cases, 4,
        tmp_path_factory.mktemp("zero2x2"), CASES_2X2, _params(), _grads(4))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_world2_matches_jax(world2, case):
    j_params, j_state = _jax_run(case, _params(), _grads(2), 2)
    _compare(case, [r[case["name"]] for r in world2], j_params, j_state, 2)
    if case.get("poison_iter") is not None:
        assert world2[0][case["name"]]["count"] == ITERS - 1


@pytest.mark.parametrize("case", CASES_2X2,
                         ids=[c["name"] for c in CASES_2X2])
def test_two_level_topology_matches_jax(world2x2, case):
    j_params, j_state = _jax_run(case, _params(), _grads(4), 4)
    _compare(case, [r[case["name"]] for r in world2x2], j_params, j_state, 2)


@pytest.mark.parametrize("case", CASES_WORLD1,
                         ids=[c["name"] for c in CASES_WORLD1])
def test_world1_in_process_matches_jax(tmp_path, case):
    got = _torch_dist.run_in_process(_torch_dist.zero_optimizer_cases,
                                     tmp_path, [case], _params(), _grads(1))
    j_params, j_state = _jax_run(case, _params(), _grads(1), 1)
    _compare(case, [got[case["name"]]], j_params, j_state, 1)


def _continue_from_jax(rank, world, j_state_np, params_np, grads_np):
    state = state_from_jax(j_state_np, rank, world, device="cpu")
    assert isinstance(state, ShardedLAMBState)
    opt = DistributedFusedLAMB(lr=1e-2, impl="fused")
    params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    opt.init(params)                     # the flat layout; state from JAX
    g = {k: torch.from_numpy(v[rank]) for k, v in grads_np.items()}
    params, state = opt.step(state, g, params)
    return {k: v.numpy() for k, v in params.items()}, state


def test_state_from_jax_continues_a_jax_run(tmp_path):
    """Two JAX steps, the state carried across with ``state_from_jax``,
    one port step: equal to three JAX steps."""
    case = CASES[1]
    grads = _grads(1)
    j2_params, j2_state = _jax_run(case, _params(), grads, 1, iters=2)
    j3_params, j3_state = _jax_run(case, _params(), grads, 1, iters=3)
    j2_np = type(j2_state)(*(np.asarray(x) for x in j2_state))
    params, state = _torch_dist.run_in_process(
        _continue_from_jax, tmp_path, j2_np,
        {k: np.asarray(v) for k, v in j2_params.items()}, grads[2])
    for k in SHAPES:
        np.testing.assert_allclose(params[k], np.asarray(j3_params[k]),
                                   atol=TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(state.p.numpy(), np.asarray(j3_state.p),
                               atol=TOL, rtol=0)
    assert int(state.count) == 3


def test_collective_schemes_not_ported_raise(tmp_path):
    """Every scheme the reduce-scatter and the all-gather once refused now
    lowers (world 1 in this process: the plain math); Adasum still has no
    all-gather meaning, and an unknown scheme is refused."""
    assert collectives.resolve(None) is None
    assert collectives.resolve("bf16").scheme == "bf16"
    spec = collectives.CollectiveSpec("bf16")
    assert collectives.resolve(spec) is spec
    with pytest.raises(ValueError, match="unknown collective scheme"):
        collectives.resolve("fp8")

    def run(rank, world):
        x = torch.linspace(-1, 1, 256)
        out = {}
        for scheme in ("bf16", "int8_blockscale", "adasum"):
            out[scheme] = collectives.reduce_scatter_flat(
                x, None, collectives.resolve(scheme))[0]
        out["ag_int8"] = collectives.allgather_flat(
            x, None, collectives.resolve("int8_blockscale"))
        with pytest.raises(ValueError, match="adasum"):
            collectives.allgather_flat(x, None,
                                       collectives.resolve("adasum"))
        return x, out

    x, out = _torch_dist.run_in_process(run, tmp_path)
    q, s = collectives.quantize_blockscale(x)
    deq = collectives.dequantize_blockscale(q, s, 256)
    assert torch.equal(out["bf16"], x.bfloat16().float())
    assert torch.equal(out["int8_blockscale"], deq)
    assert torch.equal(out["adasum"], x)
    full, wire, dt = out["ag_int8"]
    assert torch.equal(full, deq) and dt == "int8"
    assert wire == collectives.wire_bytes("int8_blockscale", 256)


def test_residual_and_bad_impl_raise(tmp_path):
    with pytest.raises(ValueError, match="impl"):
        DistributedFusedLAMB(impl="pallas")
    with pytest.raises(RuntimeError, match="AMSGrad"):
        DistributedFusedLAMB(amsgrad=True)

    def step_with_residual(rank, world):
        opt = DistributedFusedLAMB(impl="xla",
                                   collective_scheme="int8_blockscale")
        params = {"w": torch.ones(4)}
        state = opt.init(params)
        res = opt.init_residual(params)
        out = opt.step(state, {"w": torch.linspace(0.1, 0.37, 4)}, params,
                       residual=res)
        return len(out), tuple(res.shape), out[2]

    n, shape, new_res = _torch_dist.run_in_process(step_with_residual,
                                                   tmp_path)
    assert n == 3 and shape == (128,) and new_res.shape == (128,)
    assert float(new_res.abs().sum()) > 0


# the compressed and adaptive reduce-scatters, the int8 all-gather and the
# error-feedback residual, world 2 against the JAX package (its int8 codec
# jitted: the scales can sit one ulp off the codec's own, see
# test_torch_collectives.py, so everything is held to TOL)
SCHEME_CASES = [
    dict(name="lamb_fused_int8_residual", opt="lamb", residual=True,
         meter=True,
         kw=dict(lr=1e-2, impl="fused", collective_scheme="int8_blockscale")),
    dict(name="adam_xla_bf16", opt="adam",
         kw=dict(lr=1e-2, impl="xla", collective_scheme="bf16")),
    dict(name="lamb_xla_adasum", opt="lamb",
         kw=dict(lr=1e-2, impl="xla", collective_scheme="adasum")),
    dict(name="adam_fused_int8_allgather", opt="adam",
         kw=dict(lr=1e-2, impl="fused", allgather_scheme="int8_blockscale")),
    dict(name="adam_xla_int8_residual_skip", opt="adam", residual=True,
         poison_iter=1,
         kw=dict(lr=1e-2, impl="xla", collective_scheme="int8_blockscale")),
]


@pytest.fixture(scope="module")
def schemes2(tmp_path_factory):
    return _torch_dist.run_ranks(
        _torch_dist.zero_optimizer_cases, 2,
        tmp_path_factory.mktemp("zero_schemes"), SCHEME_CASES, _params(),
        _grads(2))


@pytest.mark.parametrize("case", SCHEME_CASES,
                         ids=[c["name"] for c in SCHEME_CASES])
def test_world2_schemes_match_jax(schemes2, case):
    ref = _jax_run(case, _params(), _grads(2), 2)
    j_params, j_state = ref[0], ref[1]
    _compare(case, [r[case["name"]] for r in schemes2], j_params, j_state, 2)
    if case.get("residual"):
        j_res = ref[2]
        for rank, got in enumerate(schemes2):
            res = got[case["name"]]["residual"]
            np.testing.assert_allclose(res, j_res[rank], atol=TOL, rtol=0)
            assert np.abs(res).sum() > 0
    if case.get("meter"):
        got = schemes2[0][case["name"]]["meters"]
        jm = ref[3]
        for op in ("reduce_scatter", "allgather"):
            for key in (f"zero.{op}_bytes", f"zero.{op}_compressed_bytes"):
                assert got[key] / got[f"zero.{op}_calls"] == \
                    jm[key] / jm[f"zero.{op}_calls"], key
        assert got["zero.reduce_scatter_bytes"] / \
            got["zero.reduce_scatter_compressed_bytes"] >= 3.5


def test_overflow_skip_keeps_the_residual_of_the_step_before(schemes2):
    """The poisoned step is skipped on every rank and its residual is the
    one from the step before: three steps with the second poisoned leave
    count 2."""
    for got in schemes2:
        assert got["adam_xla_int8_residual_skip"]["count"] == 2


def test_chaos_gate_fires_through_the_zero_collectives(tmp_path):
    from apex_tpu_torch.resilience import faults

    def run(rank, world):
        fired = []
        for kw in (dict(collective_scheme="int8_blockscale"),
                   dict(collective_scheme="bf16"),
                   dict(allgather_scheme="int8_blockscale")):
            opt = DistributedFusedLAMB(impl="xla", **kw)
            params = {"w": torch.ones(256)}
            state = opt.init(params)
            prev = faults.install(faults.parse("collective_fail@0"))
            try:
                opt.step(state, {"w": torch.ones(256)}, params)
                fired.append(False)
            except faults.CollectiveFault:
                fired.append(True)
            finally:
                faults.install(prev)
        return fired

    assert _torch_dist.run_in_process(run, tmp_path) == [True, True, True]
