"""The multi-tensor engine of the PyTorch port against the JAX package.

The transformer's parameter tree (from ``apex_tpu.models.transformer_init``,
carried across with ``params_from_jax``) packs into the same flat layout in
both packages: the same leaf order (dict keys sorted), offsets, total,
row ranges and values.  The per-tensor reductions and the broadcasts
agree, and the port's l2norm (its plain version on the CPU) agrees with
``apex_tpu``'s ``multi_tensor_l2norm`` (the Pallas kernel, in interpret
mode) to 1e-6 relative (fp32 sums in other orders).  The plain versions
of the ZeRO update kernels, ``fused_adam_flat`` (both decay modes, with
and without a bf16 model copy) and ``fused_lamb_stage1_flat``, agree with
the JAX kernels (interpret mode) to 1e-6 relative, with the unscale and
clip factors away from 1.  ``multi_tensor_scale`` and
``multi_tensor_axpby`` (plain versions) agree with the JAX kernels
(interpret mode) over fp32 / bf16 / fp16 inputs and outputs, the scalars
as numbers and as 0-d tensors, to 1e-6 relative (the same fp32 products
and casts; no more than a flushed subnormal apart; for axpby relative to
|a x| + |b y|, since XLA on the CPU may fuse a x + b y into one FMA where
the port rounds the product first, as the TPU kernel's order reads; into
bf16 / fp16 that one fp32 rounding may move the cast one step of the
output type, at most 2^-7 / 2^-10 relative), and their overflow
flags agree: set by an inf or a NaN input and by an fp16 output that
overflows (fp32 70000 scaled by 1), clear otherwise.  The
``multi_tensor_applier`` facade packs lists as the JAX one does.  The
CUDA kernels are compared with the plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.multi_tensor_apply import TreeFlattener as JaxFlattener
from apex_tpu.multi_tensor_apply import multi_tensor_l2norm as jax_l2norm
from apex_tpu.multi_tensor_apply import kernels as jkernels
from apex_tpu.multi_tensor_apply import multi_tensor_applier as jax_applier

from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.multi_tensor_apply import (DEFAULT_CHUNK, LANE,
                                               MultiTensorApply,
                                               TreeFlattener, kernels,
                                               multi_tensor_applier,
                                               multi_tensor_axpby,
                                               multi_tensor_l2norm,
                                               multi_tensor_l2norm_reference,
                                               multi_tensor_scale)
from apex_tpu_torch.utils.pytree import tree_leaves

DIMS = dict(vocab_size=97, max_len=48, num_layers=2, d_model=64,
            num_heads=4, d_ff=128)


@pytest.fixture(scope="module")
def trees():
    jtree = jax_init(jax.random.PRNGKey(1), JaxConfig(**DIMS))
    ptree = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                            device="cpu")
    return jtree, ptree


@pytest.mark.parametrize("chunk", [DEFAULT_CHUNK, LANE * 8])
def test_flattener_layout_matches_jax(trees, chunk):
    jtree, ptree = trees
    jf, pf = JaxFlattener(jtree, chunk=chunk), TreeFlattener(ptree,
                                                            chunk=chunk)
    assert pf.total == jf.total and pf.num_chunks == jf.num_chunks
    assert pf.num_leaves == jf.num_leaves == 18
    np.testing.assert_array_equal(pf.offsets, jf.offsets)
    assert pf.leaf_row_ranges == jf.leaf_row_ranges
    assert pf.shapes == [tuple(l.shape) for l in
                         jax.tree_util.tree_leaves(jtree)]
    np.testing.assert_array_equal(pf.flatten(ptree).numpy(),
                                  np.asarray(jf.flatten(jtree)))


def test_unflatten_roundtrip_and_dtypes(trees):
    _, ptree = trees
    fl = TreeFlattener(ptree)
    flat = fl.flatten(ptree)
    back = fl.unflatten(flat)
    for a, b in zip(tree_leaves(back), tree_leaves(ptree)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bf = fl.unflatten(flat, dtype=torch.bfloat16)
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(bf))
    like = fl.unflatten(flat, like=bf)
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(like))
    # unflatten copies: the tree does not alias the flat buffer
    flat.zero_()
    torch.testing.assert_close(back["embed"]["tok"], ptree["embed"]["tok"],
                               rtol=0, atol=0)


def test_per_tensor_reductions_match_jax(trees):
    jtree, ptree = trees
    jf, pf = JaxFlattener(jtree), TreeFlattener(ptree)
    jflat, pflat = jf.flatten(jtree), pf.flatten(ptree)
    np.testing.assert_allclose(pf.per_tensor_sumsq(pflat).numpy(),
                               np.asarray(jf.per_tensor_sumsq(jflat)),
                               rtol=1e-6)
    np.testing.assert_array_equal(pf.per_tensor_maxabs(pflat).numpy(),
                                  np.asarray(jf.per_tensor_maxabs(jflat)))
    vals = np.arange(1, pf.num_leaves + 1, dtype=np.float32)
    np.testing.assert_array_equal(
        pf.broadcast_rows(torch.from_numpy(vals)).numpy(),
        np.asarray(jf.broadcast_rows(jnp.asarray(vals))))
    np.testing.assert_array_equal(
        pf.broadcast_per_tensor(torch.from_numpy(vals)).numpy(),
        np.asarray(jf.broadcast_per_tensor(jnp.asarray(vals))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_l2norm_matches_pallas(dtype, n_chunks):
    rng = np.random.default_rng(n_chunks)
    x = rng.standard_normal(n_chunks * DEFAULT_CHUNK).astype(np.float32)
    ref = jax_l2norm(jnp.asarray(x).astype(dtype))
    got = multi_tensor_l2norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_l2norm_of_the_flat_tree_matches_jax(trees):
    jtree, ptree = trees
    jflat = JaxFlattener(jtree).flatten(jtree)
    pflat = TreeFlattener(ptree).flatten(ptree)
    np.testing.assert_allclose(multi_tensor_l2norm(pflat).item(),
                               float(jax_l2norm(jflat)), rtol=1e-6)
    assert multi_tensor_l2norm_reference(torch.zeros(0)).item() == 0.0


def test_leaf_order_is_sorted_keys():
    tree = {"b": torch.ones(3), "a": {"z": torch.zeros(2), "c": torch.ones(1)}}
    fl = TreeFlattener(tree)
    assert fl.shapes == [(1,), (2,), (3,)]
    assert fl.offsets.tolist() == [0, 128, 256, 384]


def _opt_buffers(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32) * 3.0
    p = rng.standard_normal(n).astype(np.float32)
    m = rng.standard_normal(n).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    return g, p, m, v


def _close(got, ref, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("model_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_flat_matches_pallas(adam_w_mode, model_dtype):
    n = 2 * LANE * 8
    bufs = _opt_buffers(n, seed=3 + adam_w_mode)
    # lr, b1, b2, eps, wd, rc1, rc2, scale (unscale 1/64 times clip 0.7)
    scal = np.array([[1e-2, 0.9, 0.999, 1e-8, 0.01, 1 / (1 - 0.9 ** 3),
                      1 / (1 - 0.999 ** 3), 0.7 / 64]], np.float32)
    ref = jkernels.fused_adam_flat(
        *(jnp.asarray(b) for b in bufs), jnp.asarray(scal),
        adam_w_mode=adam_w_mode,
        model_dtype=jnp.bfloat16 if model_dtype else None)
    got = kernels.fused_adam_flat(
        *(torch.from_numpy(b) for b in bufs), torch.from_numpy(scal),
        adam_w_mode=adam_w_mode,
        model_dtype=torch.bfloat16 if model_dtype else None)
    assert len(got) == len(ref) == (4 if model_dtype else 3)
    for name, a, r in zip(("p", "m", "v"), got, ref):
        assert a.dtype == torch.float32
        _close(a, r, name)
    if model_dtype:
        assert got[3].dtype == torch.bfloat16
        # the same fp32 values round to the same bf16 numbers
        np.testing.assert_array_equal(
            got[3].float().numpy(),
            np.asarray(ref[3].astype(jnp.float32)))


@pytest.mark.parametrize("beta3", [0.1, 1.0])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_lamb_stage1_flat_matches_pallas(adam_w_mode, beta3):
    n = 3 * LANE * 8
    bufs = _opt_buffers(n, seed=7 + adam_w_mode)
    # b1, b2, eps, wd, rc1, rc2, clip, inv_scale, beta3
    scal = np.array([[0.9, 0.999, 1e-6, 0.01, 1 / (1 - 0.9 ** 2),
                      1 / (1 - 0.999 ** 2), 0.35, 1 / 128, beta3]],
                    np.float32)
    ref = jkernels.fused_lamb_stage1_flat(
        *(jnp.asarray(b) for b in bufs), jnp.asarray(scal),
        adam_w_mode=adam_w_mode)
    got = kernels.fused_lamb_stage1_flat(
        *(torch.from_numpy(b) for b in bufs), torch.from_numpy(scal),
        adam_w_mode=adam_w_mode)
    for name, a, r in zip(("u", "m", "v"), got, ref):
        _close(a, r, name)


def test_update_kernels_check_their_inputs():
    bufs = [torch.zeros(256) for _ in range(4)]
    with pytest.raises(ValueError):
        kernels._check_update_inputs("adam", bufs, torch.zeros(7), 8)
    with pytest.raises(ValueError):
        kernels._check_update_inputs(
            "adam", bufs[:3] + [torch.zeros(128)], torch.zeros(8), 8)
    with pytest.raises(ValueError):
        kernels._check_update_inputs(
            "adam", bufs[:3] + [torch.zeros(256, dtype=torch.bfloat16)],
            torch.zeros(8), 8)
    assert kernels._check_update_inputs("lamb", bufs, torch.zeros(1, 9),
                                        9) == 256


DTYPES = ["float32", "bfloat16", "float16"]


def _flat(n, dtype, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _same(got, ref, flag, ref_flag):
    assert got.dtype == getattr(torch, str(ref.dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-30)
    assert flag.dtype == torch.int32 and flag.shape == ()
    assert int(flag) == int(ref_flag)


@pytest.mark.parametrize("scalar", ["number", "tensor"])
@pytest.mark.parametrize("out_dtype", [None] + DTYPES)
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_scale_matches_pallas(in_dtype, out_dtype, scalar):
    jx, px = _flat(2 * LANE * 8, in_dtype, seed=11, scale=5.0)
    s = 1.0 / 3.0
    ps = s if scalar == "number" else torch.tensor(s)
    ref, rflag = jkernels.multi_tensor_scale(jx, s, out_dtype)
    got, flag = multi_tensor_scale(
        px, ps, None if out_dtype is None else getattr(torch, out_dtype))
    _same(got, ref, flag, rflag)
    assert int(flag) == 0


@pytest.mark.parametrize("out_dtype", [None] + DTYPES)
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_axpby_matches_pallas(in_dtype, out_dtype):
    n = 3 * LANE * 8
    (jx, px), (jy, py) = _flat(n, in_dtype, 12), _flat(n, in_dtype, 13, 2.0)
    ref, rflag = jkernels.multi_tensor_axpby(jx, jy, 1.7, -0.3, out_dtype)
    got, flag = multi_tensor_axpby(
        px, py, torch.tensor(1.7), -0.3,
        None if out_dtype is None else getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, str(ref.dtype))
    assert flag.dtype == torch.int32 and int(flag) == int(rflag) == 0
    terms = np.abs(px.float().numpy() * 1.7) + np.abs(py.float().numpy() * 0.3)
    ref32 = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref32)
    rel = {"float32": 1e-6, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[
        str(ref.dtype)]
    assert (err <= rel * np.maximum(terms, np.abs(ref32)) + 1e-30).all()


@pytest.mark.parametrize("case", ["inf", "nan", "fp16_overflow", "clean"])
@pytest.mark.parametrize("op", ["scale", "axpby"])
def test_overflow_flag_matches_pallas(op, case):
    n = LANE * 8
    x = np.random.default_rng(14).standard_normal(n).astype(np.float32)
    out_dtype = None
    if case == "inf":
        x[77] = np.inf
    elif case == "nan":
        x[5] = np.nan
    elif case == "fp16_overflow":
        x[300], out_dtype = 70000.0, "float16"
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    tdt = None if out_dtype is None else getattr(torch, out_dtype)
    if op == "scale":
        ref, rflag = jkernels.multi_tensor_scale(jx, 1.0, out_dtype)
        got, flag = multi_tensor_scale(px, 1.0, tdt)
    else:
        ref, rflag = jkernels.multi_tensor_axpby(jx, jx, 1.0, 0.0, out_dtype)
        got, flag = multi_tensor_axpby(px, px, 1.0, 0.0, tdt)
    assert int(flag) == int(rflag) == (0 if case == "clean" else 1)
    np.testing.assert_array_equal(np.isfinite(got.float().numpy()),
                                  np.isfinite(np.asarray(ref, np.float32)))


def test_applier_matches_jax_facade():
    rng = np.random.default_rng(15)
    shapes = [(7, 5), (300,), (3, 4, 11), (130,)]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ys = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    (jout, jflag), jfl = jax_applier(jkernels.multi_tensor_axpby,
                                     [[jnp.asarray(a) for a in xs],
                                      [jnp.asarray(a) for a in ys]], 2.0,
                                     -0.5)
    (out, flag), fl = multi_tensor_applier(
        multi_tensor_axpby, [[torch.from_numpy(a) for a in xs],
                             [torch.from_numpy(a).half() for a in ys]],
        2.0, -0.5)
    # fp16 y packs into the fp32 layout as the JAX facade packs it: compare
    # against the JAX result on the fp16-rounded y
    (jout16, _), _ = jax_applier(
        jkernels.multi_tensor_axpby,
        [[jnp.asarray(a) for a in xs],
         [jnp.asarray(a).astype(jnp.float16) for a in ys]], 2.0, -0.5)
    assert fl.total == jfl.total and fl.offsets.tolist() == \
        jfl.offsets.tolist()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout16), rtol=1e-6)
    assert int(flag) == int(jflag) == 0
    (s_out, s_flag), fl = MultiTensorApply(chunk_size=LANE * 8)(
        multi_tensor_scale, [[torch.from_numpy(a) for a in xs]], 0.5)
    assert fl.total % (LANE * 8) == 0 and int(s_flag) == 0
    for a, back in zip(xs, fl.unflatten(s_out)):
        np.testing.assert_array_equal(back.numpy(), a * np.float32(0.5))
    np.testing.assert_allclose(np.asarray(jout)[:7 * 5],
                               2.0 * xs[0].ravel() - 0.5 * ys[0].ravel(),
                               rtol=1e-6)


def test_scale_axpby_check_their_inputs():
    """What the kernel wrappers refuse is refused before any launch (CPU
    tensors reach the checks here)."""
    x = torch.zeros(256)
    with pytest.raises(TypeError):
        kernels._scale_axpby("s", "mt_scale", (x.double(),), (1.0,), None)
    with pytest.raises(TypeError):
        kernels._scale_axpby("s", "mt_scale", (x,), (1.0,), torch.int32)
    with pytest.raises(TypeError):
        kernels._scale_axpby("a", "mt_axpby", (x, x.half()), (1.0, 1.0),
                             None)
    with pytest.raises(ValueError):
        kernels._scale_axpby("a", "mt_axpby", (x, torch.zeros(128)),
                             (1.0, 1.0), None)
    with pytest.raises(ValueError):
        kernels._scale_axpby("s", "mt_scale", (torch.zeros(2, 128),), (1.0,),
                             None)
    with pytest.raises(ValueError):
        kernels._scalar_arg(torch.zeros(2), x.device)
    ptr, val, keep = kernels._scalar_arg(torch.tensor(0.25), x.device)
    assert ptr == keep.data_ptr() and keep.dtype == torch.float32
    assert kernels._scalar_arg(3, x.device) == (None, 3.0, None)
