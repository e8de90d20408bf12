"""DistributedDataParallel, Reducer and allreduce_tree of the PyTorch port
against the JAX package.

World 2 runs as spawned gloo ranks (``tests/_torch_dist.py``), each with
its own seeded gradients (fp32 leaves and one bf16 leaf), against the JAX
``DistributedDataParallel`` / ``Reducer`` / ``allreduce_tree`` inside
``shard_map`` over a 2-device CPU mesh: averaging, the predivide factor
with and without averaging, the fp32 upcast of the bf16 leaf, a sum-only
``Reducer``.  A sum of two values is exact in either order and the scales
are powers of 2, so fp32 leaves agree bit for bit and the bf16 leaf within
one bf16 step (2^-8 relative).  ``message_size`` buckets (the reverse flat
order of the JAX ``partition_buckets``) give the same bits as one bucket;
``broadcast_params`` gives every rank rank 0's values.  The no-op knobs
warn, and every scheme, overlap and zero1 knob builds (their reductions are
held to the JAX package in ``test_torch_collectives.py``,
``test_torch_overlap.py`` and ``test_torch_weight_update.py``).

The ``--distributed --sync-bn`` step: two steps of ``resnet_train_step``
with a ``DistributedDataParallel`` at world 2 (each rank on half of each
batch, every batch norm synced) against the JAX example's ``train_step``
on a batch sharded over 2 CPU devices, amp O2 + FusedAdam, fp32
activations (fp16 weights), the dynamic scale started at 2^12 in both:
the same loss scales, the rank-averaged losses within 1e-4 relative and
the batch-norm state within 1e-4 (fp32 sums in other orders).  The 2-step
update of the fp32 masters agrees within 2e-2 relative in norm: Adam's
first steps are sign-like, so an element whose gradient is near 0 moves by
up to lr either way on a last-bit difference (here ~1e-3 = lr in the last
two stages' convolutions, 7e-3 in norm; the JAX package on 1 and on 2
devices gives the same masters).
"""
import functools
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import resnet as jr
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.parallel import DistributedDataParallel as JaxDDP
from apex_tpu.parallel import Reducer as JaxReducer
from apex_tpu.parallel import allreduce_tree as jax_allreduce_tree
from apex_tpu.parallel.mesh import shard_map
from apex_tpu.parallel.overlap import partition_buckets

import _torch_dist
from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                     allreduce_tree)
from apex_tpu_torch.parallel.overlap import \
    partition_buckets as port_partition_buckets

SHAPES = {"a": (3, 5), "b": (7,), "c": (4, 4, 3, 2), "d": (11,)}
BF16_RTOL = 2.0 ** -8


def _grads():
    rng = np.random.default_rng(21)
    return {k: rng.standard_normal((2,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _params():
    rng = np.random.default_rng(22)
    return {k: rng.standard_normal((2,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _torch_dist.run_ranks(_torch_dist.ddp_cases, 2,
                                 tmp_path_factory.mktemp("ddp"), _grads(),
                                 _params())


# case -> the JAX reduction of the same gradients
JAX_CASES = {
    "average": lambda g: JaxDDP(axis_name="data").allreduce_grads(g),
    "one_bucket": lambda g: JaxDDP(axis_name="data",
                                   delay_allreduce=True).allreduce_grads(g),
    "small_buckets": lambda g: JaxDDP(
        axis_name="data", message_size=40,
        overlap="bucketed").allreduce_grads(g),
    "predivide": lambda g: JaxDDP(
        axis_name="data", gradient_predivide_factor=2.0,
        allreduce_always_fp32=True).allreduce_grads(g),
    "predivide_sum": lambda g: JaxDDP(
        axis_name="data", gradient_predivide_factor=2.0,
        gradient_average=False,
        allreduce_always_fp32=True).allreduce_grads(g),
    "tree_fp32": lambda g: jax_allreduce_tree(g, axis_name="data",
                                              always_fp32=True),
    "reducer_sum": lambda g: JaxReducer(
        axis_name="data", gradient_average=False).reduce(g),
}


def _jax_reduce(case):
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    g = {k: jnp.asarray(v) for k, v in _grads().items()}
    g["b"] = g["b"].astype(jnp.bfloat16)

    @functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                       out_specs=P("data"))
    def run(gs):
        local = {k: v[0] for k, v in gs.items()}
        return {k: v[None] for k, v in JAX_CASES[case](local).items()}

    return {k: np.asarray(v, np.float32) for k, v in run(g).items()}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_world2_reduction_matches_jax(world2, case):
    ref = _jax_reduce(case)
    for rank, (res, _, _) in enumerate(world2):
        for k, v in res[case].items():
            if k == "b":
                np.testing.assert_allclose(v, ref[k][rank],
                                           rtol=BF16_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(v, ref[k][rank])


def test_buckets_give_the_bits_of_one_bucket_and_keep_dtypes(world2):
    for res, dtypes, _ in world2:
        for k in SHAPES:
            np.testing.assert_array_equal(res["small_buckets"][k],
                                          res["one_bucket"][k])
            np.testing.assert_array_equal(res["average"][k],
                                          res["one_bucket"][k])
        assert dtypes == {"a": "torch.float32", "b": "torch.bfloat16",
                          "c": "torch.float32", "d": "torch.float32"}


def test_broadcast_params_gives_rank0s(world2):
    p0 = {k: v[0] for k, v in _params().items()}
    for _, _, params in world2:
        for k, v in params.items():
            np.testing.assert_array_equal(v, p0[k])


@pytest.mark.parametrize("message_size", [1, 40, 100, 10_000_000])
def test_bucket_order_is_the_jax_partition(message_size):
    tree = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    layout = partition_buckets(tree, message_size=message_size)
    got = port_partition_buckets(
        {k: torch.zeros(s) for k, s in SHAPES.items()},
        message_size=message_size)
    assert [b.leaf_ids for b in got.buckets] == \
        [b.leaf_ids for b in layout.buckets]


def test_ddp_noop_knobs_warn():
    with pytest.warns(UserWarning):
        DistributedDataParallel(num_allreduce_streams=2, device="cpu")
    with pytest.warns(UserWarning):
        DistributedDataParallel(retain_allreduce_buffers=True, device="cpu")
    with pytest.warns(UserWarning, match="prof"):
        DistributedDataParallel(prof=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ddp = DistributedDataParallel(message_size=1, device="cpu")
    assert ddp.message_size == 1
    with pytest.raises(ValueError, match="shared_param"):
        DistributedDataParallel(shared_param=True, device="cpu")


@pytest.mark.parametrize("what", ["ddp_int8", "ddp_bf16", "ddp_adasum",
                                  "tree_bf16", "residuals", "reducer_int8",
                                  "overlap", "zero1", "per_leaf"])
def test_schemes_not_ported_raise(what):
    """Every knob that raised before the schemes, the overlap and zero1
    were ported now builds and, with no process group, reduces as the
    identity (the JAX package's outside a mapped context); the residuals
    come back with the tree."""
    g = {"w": torch.ones(4)}
    calls = {
        "ddp_int8": lambda: DistributedDataParallel(
            collective_scheme="int8_blockscale",
            device="cpu").allreduce_grads(g),
        "ddp_bf16": lambda: DistributedDataParallel(
            collective_scheme="bf16", device="cpu").allreduce_grads(g),
        "ddp_adasum": lambda: DistributedDataParallel(
            collective_scheme="adasum", device="cpu").allreduce_grads(g),
        "tree_bf16": lambda: allreduce_tree(g, scheme="bf16"),
        "residuals": lambda: allreduce_tree(g, residuals={"w": g["w"]})[0],
        "reducer_int8": lambda: Reducer(
            collective_scheme="int8_blockscale").reduce(g),
        "overlap": lambda: DistributedDataParallel(
            overlap="bucketed", device="cpu").allreduce_grads(g),
        "zero1": lambda: DistributedDataParallel(
            update_sharding="zero1", device="cpu").allreduce_grads(g),
        "per_leaf": lambda: allreduce_tree(g, scheme=lambda p, l: "bf16"),
    }
    assert calls[what]() is g
    if what == "residuals":
        r = {"w": torch.zeros(4)}
        out, res = allreduce_tree(g, residuals=r)
        assert out is g and res is r
    with pytest.raises(ValueError):
        DistributedDataParallel(collective_scheme="fp8", device="cpu")


def test_no_group_is_the_identity():
    g = {"w": torch.arange(4.0)}
    ddp = DistributedDataParallel(device="cpu", module=lambda x: x + 1)
    assert ddp.allreduce_grads(g) is g
    assert allreduce_tree(g) is g and Reducer().reduce(g) is g
    assert ddp.broadcast_params(g) is g
    assert ddp(1) == 2
    with pytest.raises(ValueError):
        DistributedDataParallel(overlap="sometimes", device="cpu")


CFG = dict(width=8, stage_sizes=(1, 1, 1, 1), num_classes=10)
SCALE = 4096.0


def _batches():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, (8,)).astype(np.int32)) for _ in range(2)]


def test_config3_step_world2_matches_jax_example(tmp_path):
    jcfg = jr.resnet50_config(dtype=jnp.float32, **CFG)
    params, state = jax.tree_util.tree_map(
        np.asarray, jr.resnet_init(jax.random.PRNGKey(0), jcfg))
    batches = _batches()
    res = _torch_dist.run_ranks(
        _torch_dist.resnet_ddp_steps, 2, tmp_path, params, state, batches,
        dict(CFG, dtype=torch.float32), SCALE)

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sharding = NamedSharding(mesh, P("data"))
    st = jamp.initialize(params, JaxAdam(lr=1e-3), opt_level="O2",
                         verbosity=0)
    st = st._replace(scalers=tuple(s._replace(loss_scale=jnp.float32(SCALE))
                                   for s in st.scalers))

    @jax.jit
    def train_step(state, bn_state, images, labels):    # main_amp.py's
        def loss_fn(p):
            logits, new_bn = jr.resnet_apply(p, bn_state, images, jcfg,
                                             train=True)
            lp = jax.nn.log_softmax(logits.astype(jnp.float32))
            loss = -jnp.mean(jnp.take_along_axis(lp, labels[:, None],
                                                 axis=1))
            return jamp.scale_loss(loss, state), (new_bn, loss)
        grads, (new_bn, loss) = jax.grad(loss_fn, has_aux=True)(
            state.model_params)
        return jamp.amp_step(state, grads), new_bn, loss

    bn, losses, scales = state, [], []
    for x, y in batches:
        st, bn, loss = train_step(st, bn, jax.device_put(x, sharding),
                                  jax.device_put(y, sharding))
        losses.append(float(loss))
        scales.append(float(st.loss_scale))

    for r_losses, r_scales, masters, r_bn in res:
        assert r_scales == scales == [SCALE, SCALE]
        np.testing.assert_allclose(r_losses, losses, rtol=1e-4)
        for a, b in zip(jax.tree_util.tree_leaves(bn), r_bn):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                       atol=1e-4)
        num = den = 0.0
        for a, b, p0 in zip(jax.tree_util.tree_leaves(st.master_params),
                            masters, jax.tree_util.tree_leaves(params)):
            num += float(((np.asarray(a) - b) ** 2).sum())
            den += float(((np.asarray(a) - p0) ** 2).sum())
        assert np.sqrt(num / den) <= 2e-2, np.sqrt(num / den)
    np.testing.assert_array_equal(res[0][2][0], res[1][2][0])
