"""SyncBatchNorm and groupbn of the PyTorch port against the JAX package.

World 2 runs as spawned gloo ranks (``tests/_torch_dist.py``), each on its
rows of one seeded global NHWC batch, against the JAX ``sync_batch_norm``
inside ``shard_map`` over a 2-device CPU mesh (forward, running statistics
and the x / weight / bias gradients; the port's weight and bias gradients
are per rank and are summed here, as the JAX package's are psum'd), and
against the JAX function on the whole batch on one device for the other
cases: unequal per-rank batches (3 and 5 rows, merged by count), the
fused ReLU with a residual ``z``, the NCHW layout, eval mode without
running statistics (batch statistics, synced), and groupbn's
``BatchNorm2d_NHWC``.  World 4 in groups of 2 (``create_grouped_mesh`` /
``bn_group=2``) holds the statistics inside each group, as the JAX
package's ``group`` mesh axis does.  Everything is fp32: values agree
within 1e-5 and gradients within 1e-4, times max(1, the reference's
largest value) (sums in other orders).  Without a process group the op
is the single-device batch norm; ``convert_syncbn_model`` swaps the port's
batch-norm-like modules.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import sync_batch_norm as jax_sbn
from apex_tpu.parallel.mesh import create_grouped_mesh, shard_map
from apex_tpu.utils.pallas import has_vma

import _torch_dist
from apex_tpu_torch.contrib.groupbn import bn_add_relu_nhwc, bn_nhwc
from apex_tpu_torch.parallel import (SyncBatchNorm, batch_norm_stats,
                                     convert_syncbn_model, sync_batch_norm)

N, H, W, C = 8, 3, 4, 6
VAL_TOL, GRAD_TOL = 1e-5, 1e-4


def _data():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(N, H, W, C) * 2 + 0.5, gy=f(N, H, W, C), z=f(N, H, W, C),
                w=rng.uniform(0.5, 1.5, C).astype(np.float32), b=f(C),
                counts=[3, 5])


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"{what}: {err}"


def _cat(results, case, name):
    return np.concatenate([r[case][name] for r in results])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _torch_dist.run_ranks(_torch_dist.syncbn_cases, 2,
                                 tmp_path_factory.mktemp("syncbn"), _data())


def _whole(d, x, z=None, fuse_relu=False, training=True, stats=True):
    """The JAX function on the whole batch, on one device, with its
    gradients against ``gy``."""
    rm, rv = (jnp.zeros(C), jnp.ones(C)) if stats else (None, None)

    def f(x, w, b):
        y, nrm, nrv = jax_sbn(x, w, b, rm, rv, axis_name=None,
                              training=training, fuse_relu=fuse_relu, z=z)
        return jnp.sum(y * d["gy"]), (y, nrm, nrv)
    (gx, gw, gb), (y, nrm, nrv) = jax.grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(x, d["w"], d["b"])
    return dict(y=y, rm=nrm, rv=nrv, gx=gx, gw=gw, gb=gb)


def test_world2_matches_jax_on_a_2_device_mesh(world2):
    d = _data()
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    vma = has_vma()

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data"), P(), P(), P("data")),
        out_specs=(P("data"), P(), P(), P("data"), P(), P()),
        **({} if vma else {"check_vma": False}))
    def run(xs, w, b, gys):
        def f(xs, w, b):
            y, rm, rv = jax_sbn(xs, w, b, jnp.zeros(C), jnp.ones(C),
                                axis_name="data")
            return jnp.sum(y * gys), (y, rm, rv)
        (gx, gw, gb), (y, rm, rv) = jax.grad(
            f, argnums=(0, 1, 2), has_aux=True)(xs, w, b)
        if not vma:
            gw, gb = jax.lax.psum(gw, "data"), jax.lax.psum(gb, "data")
        return y, rm, rv, gx, gw, gb

    ref = dict(zip(("y", "rm", "rv", "gx", "gw", "gb"),
                   run(d["x"], d["w"], d["b"], d["gy"])))
    _close(_cat(world2, "nhwc", "y"), ref["y"], VAL_TOL, "y")
    _close(_cat(world2, "nhwc", "gx"), ref["gx"], GRAD_TOL, "gx")
    for r in world2:
        _close(r["nhwc"]["rm"], ref["rm"], VAL_TOL, "running mean")
        _close(r["nhwc"]["rv"], ref["rv"], VAL_TOL, "running var")
    for g in ("gw", "gb"):
        _close(sum(r["nhwc"][g] for r in world2), ref[g], GRAD_TOL, g)
    # the global count: unbiased running var over N * H * W
    var = d["x"].reshape(-1, C).var(0)
    n = N * H * W
    _close(world2[0]["nhwc"]["rv"], 0.9 + 0.1 * var * n / (n - 1), 1e-4)


@pytest.mark.parametrize("case", ["unequal", "relu_z", "nchw",
                                  "eval_no_stats", "groupbn"])
def test_world2_case_matches_jax_whole_batch(world2, case):
    d = _data()
    x = jnp.asarray(d["x"])
    if case == "unequal":
        assert [r["unequal"]["y"].shape[0] for r in world2] == d["counts"]
        ref = _whole(d, x)
        for r in world2:
            for s in ("rm", "rv"):
                _close(r[case][s], ref[s], VAL_TOL, s)
        _close(_cat(world2, case, "gx"), ref["gx"], GRAD_TOL, "gx")
        _close(sum(r[case]["gw"] for r in world2), ref["gw"], GRAD_TOL)
    elif case == "relu_z":
        ref = _whole(d, x, z=d["z"], fuse_relu=True, stats=False)
        _close(_cat(world2, case, "gx"), ref["gx"], GRAD_TOL, "gx")
        assert (_cat(world2, case, "y") == 0).any()
    elif case == "nchw":
        ref = _whole(d, x)
        for s in ("rm", "rv"):
            _close(world2[1][case][s], ref[s], VAL_TOL, s)
    elif case == "eval_no_stats":
        ref = dict(y=jax_sbn(x, None, None, axis_name=None,
                             training=False)[0])
    else:                       # groupbn: fused relu + z, synced stats
        y, rm, rv = jax_sbn(x, jnp.ones(C), jnp.zeros(C), jnp.zeros(C),
                            jnp.ones(C), axis_name=None, fuse_relu=True,
                            z=d["z"])
        ref = dict(y=y)
        for r in world2:
            _close(r[case]["rm"], rm, VAL_TOL)
            _close(r[case]["rv"], rv, VAL_TOL)
    _close(_cat(world2, case, "y"), ref["y"], VAL_TOL, "y")


def test_world4_groups_of_2_match_jax_group_axis(tmp_path):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((8, 2, 2, 3)).astype(np.float32)
    x[4:] = x[4:] * 3 + 10.0          # the second group sees other data
    res = _torch_dist.run_ranks(_torch_dist.syncbn_grouped, 4, tmp_path, x)
    gmesh = create_grouped_mesh(2, devices=jax.devices()[:4])

    @functools.partial(shard_map, mesh=gmesh,
                       in_specs=P(("data", "group")),
                       out_specs=P(("data", "group")))
    def run(xs):
        return jax_sbn(xs, None, None, axis_name="group")[0]

    ref = np.asarray(run(jnp.asarray(x)))
    _close(np.concatenate([r["y"] for r in res]), ref, VAL_TOL, "group y")
    _close(np.concatenate([r["y2"] for r in res]), ref, VAL_TOL, "bn_group")
    for g in (0, 1):                  # running means differ by group
        rows = x[4 * g:4 * g + 4].reshape(-1, 3)
        _close(res[2 * g]["rm"], 0.1 * rows.mean(0), VAL_TOL)
    assert [r["data_sum"] for r in res] == [2.0, 4.0, 2.0, 4.0]


def test_no_group_is_single_device_batch_norm():
    d = _data()
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    w, b = torch.from_numpy(d["w"]), torch.from_numpy(d["b"])
    ref = _whole(d, jnp.asarray(d["x"]), stats=True)
    y, rm, rv = sync_batch_norm(x, w, b, torch.zeros(C), torch.ones(C))
    gx, = torch.autograd.grad((y * torch.from_numpy(d["gy"])).sum(), x)
    _close(y.detach().numpy(), ref["y"], VAL_TOL, "y")
    _close(gx.numpy(), ref["gx"], GRAD_TOL, "gx")
    _close(rv.numpy(), ref["rv"], VAL_TOL, "rv")
    mean, var, n = batch_norm_stats(x.detach(), (0, 1, 2), None)
    assert float(n) == N * H * W and float(var.min()) >= 0.0
    y1, _, _ = bn_nhwc(x.detach(), w, b, torch.zeros(C), torch.ones(C))
    assert torch.equal(y1, y.detach())
    z = torch.from_numpy(d["z"])
    y2, _, _ = bn_add_relu_nhwc(x.detach(), z, w, b, torch.zeros(C),
                                torch.ones(C))
    ref2 = jax_sbn(jnp.asarray(d["x"]), d["w"], d["b"], jnp.zeros(C),
                   jnp.ones(C), axis_name=None, fuse_relu=True, z=d["z"])[0]
    _close(y2.numpy(), ref2, VAL_TOL, "add relu")
    # a float64 input keeps float64 (fp32 and narrower compute in fp32)
    x64 = torch.from_numpy(d["x"]).double()
    y64, _, rv64 = sync_batch_norm(x64, w, b, torch.zeros(C), torch.ones(C))
    xn = d["x"].astype(np.float64).reshape(-1, C)
    ref64 = (xn - xn.mean(0)) / np.sqrt(xn.var(0) + 1e-5) * d["w"] + d["b"]
    assert y64.dtype == torch.float64 and rv64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy().reshape(-1, C), ref64, rtol=0,
                               atol=1e-12)
    yh, _, _ = sync_batch_norm(x.detach().half(), w, b)
    assert yh.dtype == torch.float16
    _close(yh.float().numpy(), ref["y"], 2e-3, "fp16 in, fp32 math")
    # eval mode on the running statistics, with the fused ReLU
    xe = torch.linspace(-2, 2, 16).reshape(8, 2)
    ye, _, _ = sync_batch_norm(xe, None, None, torch.zeros(2), torch.ones(2),
                               training=False, fuse_relu=True)
    _close(ye.numpy(), np.maximum(xe.numpy(), 0.0) / np.sqrt(1 + 1e-5),
           VAL_TOL)


def test_convert_syncbn_model():
    class BatchNorm:                 # a stand-in batch-norm module
        __module__ = "apex_tpu_torch.models.layers"

        def __init__(self, n):
            self.num_features, self.eps, self.momentum = n, 1e-5, 0.1
            self.affine, self.track_running_stats = True, False

    class Block:
        __module__ = "apex_tpu_torch.models.layers"

        def __init__(self):
            self.bn = BatchNorm(8)
            self.sub = [BatchNorm(4), "not_a_module"]
            self.named = {"k": BatchNorm(2)}

    blk = Block()
    conv = convert_syncbn_model(blk, process_group="g")
    assert isinstance(conv.bn, SyncBatchNorm) and conv.bn.num_features == 8
    assert conv.bn.axis_name == "g" and not conv.bn.track_running_stats
    assert isinstance(conv.sub[0], SyncBatchNorm)
    assert conv.sub[1] == "not_a_module"
    assert isinstance(conv.named["k"], SyncBatchNorm)
    assert isinstance(blk.bn, BatchNorm)            # input not mutated
    params, state = conv.bn.init(device="cpu")
    assert params["weight"].shape == (8,) and state == {}
