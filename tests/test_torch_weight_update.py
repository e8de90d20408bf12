"""The port's weight-update sharding (zero1) against the JAX package's
``parallel.weight_update``.

- The knobs: :func:`resolve_mode` (explicit > ``APEX_TPU_UPDATE_SHARDING``
  > off), ``layout_meta`` and ``state_pspecs`` (which fields are
  shard-length) as the JAX ones give them; ``DistributedDataParallel.
  weight_update`` returns None when the mode is off.
- Inside the port: ``ShardedUpdate`` over ``FusedAdam`` is bitwise the
  unsharded ``step_flat`` on the averaged gradients, at world 1 (in this
  process) and world 2 (spawned gloo ranks, ``tests/_torch_dist.py``); LAMB
  and NovoGrad's ``step_flat_shard`` equal their ``step_flat`` bit for bit
  at world 1 and within 1e-6 of the largest parameter at world 2 (their
  per-tensor norms sum over two shards); an overflow skip keeps the old
  state and reverts the int8 error-feedback residual; the chaos gate fires
  through the compressed reduce-scatter of the zero1 path.
- Against the JAX package: 6 steps of the tiny flagship transformer
  (``tests/L0/test_weight_update.py``'s config, the JAX weights) through
  the port's ``build_flagship_step`` and the JAX ``parallel.plan.
  build_flagship_step`` at world 2, in modes off, bucketed, zero1 and
  zero1 + bucketed: the port's four runs bitwise one another; the losses
  within 1e-6 relative of JAX's zero1 run, the parameters within 1e-5 of
  the largest parameter (Adam divides by sqrt(v), so an element whose
  gradient is near 0 carries two frameworks' product-order differences,
  ~1e-8, up to ~5e-6 in 6 steps at lr 1e-2); the int8 run (int8
  reduce-scatter and all-gather) within 1 % of the fp32 run's loss.  The
  meters' logical and wire bytes a call and the optimizer-state gauge equal
  the JAX counters.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from apex_tpu.models import TransformerConfig as JaxCfg
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.parallel import weight_update as jwu
from apex_tpu.parallel.plan import build_flagship_step as jax_flagship
from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry.registry import MemorySink as JMemorySink
from apex_tpu.telemetry.registry import Registry as JRegistry

import _torch_dist
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedNovoGrad
from apex_tpu_torch.parallel import DistributedDataParallel, ShardedUpdate
from apex_tpu_torch.parallel import weight_update as twu

TINY = dict(vocab_size=64, max_len=16, num_layers=1, d_model=32,
            num_heads=2, d_ff=64)
STEPS = 6
SHAPES = {"p0": (33, 7), "p1": (128,), "p2": (3, 5, 11), "p3": (257,)}


@pytest.fixture(autouse=True)
def _clean_env():
    prev = os.environ.pop(twu.ENV_KNOB, None)
    yield
    os.environ.pop(twu.ENV_KNOB, None)
    if prev is not None:
        os.environ[twu.ENV_KNOB] = prev


def test_modes_and_env_match_jax():
    assert twu.MODES == jwu.MODES and twu.ENV_KNOB == jwu.ENV_KNOB
    assert twu.resolve_mode() == jwu.resolve_mode() == "off"
    os.environ[twu.ENV_KNOB] = "ZERO1"
    assert twu.resolve_mode() == jwu.resolve_mode() == "zero1"
    assert twu.resolve_mode("off") == "off"
    with pytest.raises(ValueError):
        twu.resolve_mode("zero3")
    os.environ[twu.ENV_KNOB] = "zero1"
    assert isinstance(DistributedDataParallel(device="cpu").weight_update(
        FusedAdam(impl="fused")), ShardedUpdate)
    del os.environ[twu.ENV_KNOB]
    assert DistributedDataParallel(device="cpu").weight_update(
        FusedAdam(impl="fused")) is None
    with pytest.raises(ValueError, match="impl='fused'"):
        ShardedUpdate(FusedAdam(impl="xla"))
    with pytest.raises(ValueError):
        DistributedDataParallel(update_sharding="zero2", device="cpu")


def _params():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("opt", ["adam", "lamb", "novograd"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_layout_and_state_specs_match_jax(opt, n):
    jcls = {"adam": JaxAdam}.get(opt)
    tcls = {"adam": FusedAdam, "lamb": FusedLAMB, "novograd": FusedNovoGrad}
    params = _params()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    su = ShardedUpdate(tcls[opt](impl="fused"))
    meta = su.layout_meta(tp, n)
    if jcls is not None:
        jsu = jwu.ShardedUpdate(jcls(impl="fused"))
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        assert meta == jsu.layout_meta(jp, n)
        jspec = jsu.state_pspecs(jp, n)
        got = su.state_pspecs(tp, n)
        assert tuple(got) == tuple("shard" if s == jax.sharding.
                                   PartitionSpec("data") else "replicated"
                                   for s in jspec)
    assert meta["flat_total"] % (128 * n) == 0
    specs = su.state_pspecs(tp, n)
    assert specs.count == "replicated" and specs.master == "shard"
    if opt == "novograd":
        assert specs.v == "replicated"


SHARD_CASES = [
    dict(name="adam", opt="adam", kw=dict(lr=1e-2, weight_decay=0.01)),
    dict(name="lamb", opt="lamb", kw=dict(lr=1e-2)),
    dict(name="novograd", opt="novograd", kw=dict(lr=1e-2)),
    dict(name="novograd_inf", opt="novograd", kw=dict(lr=1e-2, norm_type=0)),
    dict(name="adam_int8_skip", opt="adam", kw=dict(lr=1e-2),
         su=dict(collective_scheme="int8_blockscale:min_bytes=0"),
         residual=True, poison_iter=1, chaos=True),
]


def _grads(world):
    rng = np.random.default_rng(7)
    return [{k: rng.standard_normal((world,) + s).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(3)]


@pytest.fixture(scope="module")
def sharded2(tmp_path_factory):
    return _torch_dist.run_ranks(
        _torch_dist.sharded_optimizer_cases, 2,
        tmp_path_factory.mktemp("wu2"), _params(), _grads(2), SHARD_CASES)


@pytest.fixture(scope="module")
def sharded1(tmp_path_factory):
    return [_torch_dist.run_in_process(
        _torch_dist.sharded_optimizer_cases, tmp_path_factory.mktemp("wu1"),
        _params(), _grads(1), SHARD_CASES)]


@pytest.mark.parametrize("case", [c["name"] for c in SHARD_CASES[:4]])
def test_step_flat_shard_is_the_unsharded_step(sharded1, sharded2, case):
    for world, res in ((1, sharded1), (2, sharded2)):
        for rank in res:
            got = rank[case]
            for k in SHAPES:
                a, b = got["sharded"][k], got["unsharded"][k]
                if world == 1 or case == "adam":
                    np.testing.assert_array_equal(a, b, err_msg=k)
                else:
                    scale = np.abs(b).max()
                    assert np.abs(a - b).max() <= 1e-6 * scale, k
        masters = [rank[case]["master_len"] for rank in res]
        assert len(set(masters)) == 1
    assert sharded2[0][case]["master_len"] * 2 == \
        sharded1[0][case]["master_len"]


def test_overflow_skip_reverts_the_residual_and_chaos_fires(sharded1,
                                                            sharded2):
    for res in (sharded1, sharded2):
        for rank in res:
            got = rank["adam_int8_skip"]
            assert got["skipped_res"] is True
            assert got["res_nonzero"] is True
            assert got["chaos"] is True


# -- the tiny flagship at world 2 against the JAX package ---------------------------

def _jax_cfg():
    return JaxCfg(**TINY, dtype=jnp.float32)


def _tokens():
    rng = np.random.default_rng(11)
    return rng.integers(0, 64, (STEPS, 4, 16)).astype(np.int32)


def _jax_run(ddp_kwargs, meter=False):
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    reg = JRegistry(sink=JMemorySink(), flush_interval=0, rank0_only=False)
    if meter:
        jevents.set_default(reg)
    try:
        carry, step = jax_flagship(_jax_cfg(), mesh, global_batch=4,
                                   ddp_kwargs=ddp_kwargs)
        params0 = jax.tree_util.tree_map(np.asarray, carry[0])
        losses = []
        for t in _tokens():
            carry, loss = step(carry, jnp.asarray(t))
            losses.append(float(loss))
        vals = reg.read() if meter else None
    finally:
        jevents.set_default(None)
    return params0, losses, jax.tree_util.tree_map(np.asarray, carry[0]), \
        vals


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    params0, losses, params, vals = _jax_run({"update_sharding": "zero1"},
                                             meter=True)
    ranks = _torch_dist.run_ranks(
        _torch_dist.flagship_cases, 2, tmp_path_factory.mktemp("flag"),
        _tokens().astype(np.int64), dict(TINY), STEPS, params0)
    return (losses, params, vals), ranks


def _leaves(tree):
    return [tree[g][k] for g in sorted(tree) for k in sorted(tree[g])]


def test_flagship_modes_are_bitwise_one_another(flagship):
    _, ranks = flagship
    for res in ranks:
        base_l, base_p, _ = res["off"]
        for mode in ("bucketed", "zero1", "zero1_bucketed"):
            losses, params, _ = res[mode]
            assert losses == base_l, mode
            for a, b in zip(_leaves(params), _leaves(base_p)):
                np.testing.assert_array_equal(a, b, err_msg=mode)
    for a, b in zip(_leaves(ranks[0]["zero1"][1]),
                    _leaves(ranks[1]["zero1"][1])):
        np.testing.assert_array_equal(a, b)


def test_flagship_zero1_matches_jax_over_six_steps(flagship):
    (j_losses, j_params, _), ranks = flagship
    losses, params, _ = ranks[0]["zero1"]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-6)
    ref = _leaves(j_params)
    got = _leaves(params)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-5 * scale
    assert losses[-1] < losses[0]


def test_flagship_int8_tracks_the_fp32_run(flagship):
    _, ranks = flagship
    fp32, _, _ = ranks[0]["zero1"]
    int8, _, meters = ranks[0]["zero1_int8"]
    assert max(abs(a - b) / abs(b) for a, b in zip(int8, fp32)) <= 1e-2
    assert meters["ddp.reduce_scatter_bytes"] / \
        meters["ddp.reduce_scatter_compressed_bytes"] >= 3.5
    assert meters["ddp.param_allgather_bytes"] / \
        meters["ddp.param_allgather_compressed_bytes"] >= 3.5


def test_flagship_meters_match_jax_counters(flagship):
    """The JAX step meters when it is traced, the port's once a step: the
    bytes a call agree."""
    (_, _, jvals), ranks = flagship
    got = ranks[0]["zero1"][2]
    assert got["ddp.reduce_scatter_calls"] == \
        got["ddp.param_allgather_calls"] == STEPS
    for op in ("reduce_scatter", "param_allgather"):
        for key in (f"ddp.{op}_bytes", f"ddp.{op}_compressed_bytes"):
            assert got[key] / got[f"ddp.{op}_calls"] == \
                jvals[key] / jvals[f"ddp.{op}_calls"], key
    for key in ("ddp.opt_state_bytes_per_replica", "ddp.update_shard_world"):
        assert got[key] == jvals[key], key
