"""Layer norm of the PyTorch port against the JAX package.

The same numpy inputs go to ``apex_tpu.ops.layer_norm.ln_fwd_pallas`` /
``ln_bwd_pallas`` (the Pallas kernels, in interpret mode on the CPU) and to
the port's ``ln_fwd`` / ``ln_bwd``, which on a CPU tensor take their plain
versions; the port's autograd gradients (dx, dw, db) are held to
``jax.grad`` of the JAX package's ``fused_layer_norm_affine``.  Tolerances:
fp32 1e-5 (fp32 reductions in different orders), bf16 1e-2 (one bf16
rounding of the output).  The kernels themselves run only on the card:
``tests/test_torch_cuda_kernels.py`` compares them with the plain versions
there.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.normalization import fused_layer_norm_affine as jax_ln_affine
from apex_tpu.ops.layer_norm import ln_bwd_pallas, ln_fwd_pallas

from apex_tpu_torch.normalization import (FusedLayerNorm, fused_layer_norm,
                                          fused_layer_norm_affine)
from apex_tpu_torch.ops import layer_norm as port_ln

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(n, h, affine, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 2.0 + 0.5).astype(np.float32)
    w = rng.standard_normal(h).astype(np.float32) if affine else None
    b = rng.standard_normal(h).astype(np.float32) if affine else None
    return x, w, b


def _jnp(a, dtype):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,h", [(1, 16), (7, 40), (64, 64), (130, 128)])
def test_ln_fwd_matches_pallas(n, h, affine, dtype):
    x, w, b = _inputs(n, h, affine, seed=n + h)
    j_out, j_mean, j_inv = ln_fwd_pallas(_jnp(x, dtype), _jnp(w, dtype),
                                         _jnp(b, dtype), 1e-5)
    tdt = getattr(torch, dtype)
    p_out, p_mean, p_inv = port_ln.ln_fwd(_torch(x, tdt), _torch(w, tdt),
                                          _torch(b, tdt), 1e-5)
    assert p_out.dtype == tdt and p_out.shape == (n, h)
    assert p_mean.shape == (n, 1) and p_inv.shape == (n, 1)
    assert p_mean.dtype == torch.float32 and p_inv.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(p_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(p_mean.numpy(), np.asarray(j_mean),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(p_inv.numpy(), np.asarray(j_inv),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape,nshape", [((2, 9, 32), (32,)),
                                          ((3, 4, 8), (4, 8))])
def test_fused_layer_norm_matches_jax(shape, nshape, affine):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(nshape).astype(np.float32) if affine else None
    b = rng.standard_normal(nshape).astype(np.float32) if affine else None
    ref = jax_ln_affine(jnp.asarray(x), _jnp(w, jnp.float32),
                        _jnp(b, jnp.float32), nshape)
    if affine:
        out = fused_layer_norm_affine(torch.from_numpy(x),
                                      _torch(w, torch.float32),
                                      _torch(b, torch.float32), nshape)
    else:
        out = fused_layer_norm(torch.from_numpy(x), nshape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_fused_layer_norm_module_matches_torch():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32))
    mod = FusedLayerNorm(48, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(
            rng.standard_normal(48).astype(np.float32)))
        mod.bias.copy_(torch.from_numpy(
            rng.standard_normal(48).astype(np.float32)))
    ref = torch.nn.functional.layer_norm(x, (48,), mod.weight, mod.bias)
    np.testing.assert_allclose(mod(x).detach().numpy(),
                               ref.detach().numpy(), atol=1e-5)
    assert FusedLayerNorm(48, elementwise_affine=False,
                          device="cpu").weight is None


def test_normalized_shape_mismatch_raises():
    with pytest.raises(ValueError):
        fused_layer_norm(torch.zeros(2, 16), (8,))


@pytest.mark.parametrize("bad", ["float64_x", "mixed_affine_dtypes",
                                 "weight_on_another_device",
                                 "non_contiguous", "half_affine",
                                 "weight_shape"])
def test_kernel_input_checks(bad):
    """The checks the CUDA wrapper applies before a launch (run here on CPU
    tensors; the launch itself needs the card).  Any width, any alignment
    and fp16 are taken (:func:`test_ln_plan_pins_paths`); float64, a weight
    and bias of two dtypes, a weight on another device, a non-contiguous x
    and wrong shapes are refused."""
    x = torch.zeros(4, 64)
    w, b = torch.ones(64), torch.zeros(64)
    if bad == "float64_x":
        x = x.double()
    elif bad == "mixed_affine_dtypes":
        w = w.bfloat16()
    elif bad == "weight_on_another_device":
        w = torch.ones(64, device="meta")
    elif bad == "non_contiguous":
        x = torch.zeros(64, 4).t()
    elif bad == "half_affine":
        b = None
    elif bad == "weight_shape":
        w, b = torch.ones(32), torch.zeros(32)
    with pytest.raises((ValueError, TypeError)):
        port_ln._check_cuda_inputs(x, w, b)


def test_kernel_refuses_grad():
    """The forward kernel no longer refuses inputs that require a gradient:
    :class:`LayerNormFunction` pairs it with the backward kernel."""
    x = torch.zeros(4, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    port_ln._check_cuda_inputs(x, w, torch.zeros(64, requires_grad=True))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,h", [(1, 16), (7, 40), (130, 128)])
def test_ln_bwd_matches_pallas(n, h, affine):
    x, w, _ = _inputs(n, h, affine, seed=3 * n + h)
    g = np.random.default_rng(n).standard_normal((n, h)).astype(np.float32)
    _, j_mean, j_inv = ln_fwd_pallas(jnp.asarray(x), _jnp(w, jnp.float32),
                                     _jnp(w, jnp.float32), 1e-5)
    ref = ln_bwd_pallas(jnp.asarray(g), jnp.asarray(x), j_mean, j_inv,
                        _jnp(w, jnp.float32), 1e-5)
    got = port_ln.ln_bwd(torch.from_numpy(g), torch.from_numpy(x),
                         torch.from_numpy(np.array(j_mean)),
                         torch.from_numpy(np.array(j_inv)),
                         _torch(w, torch.float32))
    assert got.shape == (n, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape,nshape", [((2, 9, 32), (32,)),
                                          ((5, 40), (40,)),
                                          ((3, 4, 8), (4, 8))])
def test_fused_layer_norm_grads_match_jax(shape, nshape, affine):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    w = rng.standard_normal(nshape).astype(np.float32) if affine else None
    b = rng.standard_normal(nshape).astype(np.float32) if affine else None
    g = rng.standard_normal(shape).astype(np.float32)

    def jloss(x_, w_, b_):
        return jnp.sum(jax_ln_affine(x_, w_, b_, nshape) * jnp.asarray(g))

    argnums = (0, 1, 2) if affine else (0,)
    j_grads = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x), _jnp(w, jnp.float32), _jnp(b, jnp.float32))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _torch(w, torch.float32)
    bt = _torch(b, torch.float32)
    inputs = [xt] + ([wt.requires_grad_(True), bt.requires_grad_(True)]
                     if affine else [])
    out = fused_layer_norm_affine(xt, wt, bt, nshape)
    p_grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for name, a, r in zip(("dx", "dw", "db"), p_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("bad", ["g_shape", "g_dtype", "mean_dtype"])
def test_ln_bwd_kernel_input_checks(bad, monkeypatch):
    """The checks the CUDA backward wrapper applies before a launch (the
    tensors are CPU tensors dressed as CUDA ones; no launch happens)."""
    x, g = torch.zeros(4, 64), torch.zeros(4, 64)
    mean, inv = torch.zeros(4, 1), torch.ones(4, 1)
    if bad == "g_shape":
        g = torch.zeros(4, 32)
    elif bad == "g_dtype":
        g = g.bfloat16()
    else:
        mean = mean.double()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises((ValueError, TypeError)):
        port_ln.ln_bwd(g, x, mean, inv, None)


# (H, dtype, every pointer 16-byte aligned, backward) -> (path, 16-byte
# loads): a warp a row up to 128 loads, a 256-thread block up to 1024, then
# the wide path, its row (the backward: g and x) staged in shared memory
# while it fits in a block's 227 KB
PLAN_CASES = [
    (1024, "bfloat16", True, False, ("warp", True)),
    (1024, "float16", True, True, ("warp", True)),
    (1024, "float32", True, True, ("block", True)),
    (512, "float32", True, False, ("warp", True)),
    (16, "bfloat16", True, False, ("warp", True)),
    (33, "float32", True, False, ("warp", False)),
    (60, "bfloat16", True, True, ("warp", False)),
    (100, "float16", True, False, ("warp", False)),
    (1000, "bfloat16", True, True, ("warp", True)),
    (1000, "float32", True, False, ("block", True)),
    (1024, "float16", False, True, ("block", False)),
    (4096, "float32", True, True, ("block", True)),
    (4096, "float32", False, False, ("wide_smem", False)),
    (8192, "bfloat16", True, True, ("block", True)),
    (8200, "bfloat16", True, False, ("wide_smem", True)),
    (12288, "bfloat16", True, False, ("wide_smem", True)),
    (12288, "float32", True, True, ("wide_smem", True)),
    (65536, "bfloat16", True, False, ("wide_smem", True)),
    (65536, "bfloat16", True, True, ("wide_reread", True)),
    (65536, "float32", True, False, ("wide_reread", True)),
    (65536, "float16", False, True, ("wide_reread", False)),
]


@pytest.mark.parametrize("h,dtype,aligned,backward,want", PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'al' if c[2] else 'unal'}-"
                              f"{'bwd' if c[3] else 'fwd'}"
                              for c in PLAN_CASES])
def test_ln_plan_pins_paths(h, dtype, aligned, backward, want):
    got = port_ln._ln_plan(h, getattr(torch, dtype), aligned, backward)
    assert got == want
    assert got[0] in port_ln.LN_PATHS
    # the register paths end at MAX_H for aligned rows
    if aligned and h % (16 // torch.empty((), dtype=getattr(
            torch, dtype)).element_size()) == 0:
        assert (got[0] in ("warp", "block")) == (
            h <= port_ln.MAX_H[getattr(torch, dtype)])


def test_ln_plan_reads_alignment_from_every_pointer():
    x = torch.zeros(4, 1024, dtype=torch.bfloat16)
    assert port_ln._aligned(x, None, torch.ones(1024))
    # a view one element in: 2 bytes off 16
    assert not port_ln._aligned(x.view(-1)[1:1 + 8 * 1024 - 8])
    assert not port_ln._aligned(x, torch.ones(1025)[1:])


# widths off the 16-byte vector, past the register paths, and a 3-d
# normalized shape in fp32: the port against the JAX package's
# fused_layer_norm_affine (out and jax.grad's dx, dw, db)
WIDE_CASES = [((5, 33), (33,)), ((3, 32, 16, 16), (32, 16, 16)),
              ((4, 12288), (12288,))]


@pytest.mark.parametrize("shape,nshape", WIDE_CASES,
                         ids=["h33", "32x16x16", "h12288"])
def test_any_width_matches_jax(shape, nshape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    w = rng.standard_normal(nshape).astype(np.float32)
    b = rng.standard_normal(nshape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def jloss(x_, w_, b_):
        return jnp.sum(jax_ln_affine(x_, w_, b_, nshape) * jnp.asarray(g))

    ref = jax_ln_affine(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        nshape)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    mod = FusedLayerNorm(nshape, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
    out = mod(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    p_grads = torch.autograd.grad(out, [xt, mod.weight, mod.bias],
                                  torch.from_numpy(g))
    for name, a, r in zip(("dx", "dw", "db"), p_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    fn_out = fused_layer_norm_affine(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), nshape)
    np.testing.assert_allclose(fn_out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
