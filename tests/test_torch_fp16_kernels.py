"""The fp16 instances of the port's kernels against the JAX package in fp16.

The JAX package's kernels take any float type: flash writes out and dq /
dk / dv in q's dtype, layer norm out and dx in x's, the cross-entropy
reads any logits into an fp32 loss and lse, the l2norm any flat buffer
into an fp32 sum, and Adam's model copy takes any ``model_dtype``.  The
same numpy inputs, rounded to fp16 by both packages, go to the JAX
package's Pallas kernels (interpret mode on the CPU) and to the port's
wrappers, which on a CPU tensor take their plain versions.

Tolerances: an fp16 output within 2e-3 of the JAX package's, scaled by
max(1, |ref|) (fp16's steps are 2^-11 relative: the two packages round
one fp32 value, summed in other orders, and may land on neighbouring
fp16 numbers); attention's on the peak rule (the floor of 1 lowered to
the tensor's largest |value|); a gradient within 2e-3 relative in norm
(its small elements carry the cancellation of rounded products); fp32
results of fp16 inputs (lse, the loss, the l2 norm, Adam's fp32 buffers)
at the fp32 tests' limits; the fp16 model copy within one fp16 step
(1e-3 relative).  The CUDA kernels themselves are compared with the
plain versions on the card by ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.multihead_attn import flash as jflash
from apex_tpu.contrib.xentropy import softmax_xentropy as jxent
from apex_tpu.multi_tensor_apply import kernels as jkernels
from apex_tpu.ops.layer_norm import ln_bwd_pallas, ln_fwd_pallas

from apex_tpu_torch.contrib.multihead_attn import flash as pflash
from apex_tpu_torch.contrib.xentropy import softmax_xentropy as pxent
from apex_tpu_torch.multi_tensor_apply import kernels as pkernels
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.utils import build

OUT_TOL = 2e-3
GRAD_TOL = 2e-3


def _h(a):
    """numpy fp32 -> (the JAX fp16 array, the port's fp16 tensor)."""
    return (jnp.asarray(a).astype(jnp.float16),
            torch.from_numpy(np.ascontiguousarray(a)).half())


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _scaled(got, ref, tol):
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), err.max()


def _peak(got, ref, tol):
    got, ref = _np(got), _np(ref)
    a = np.abs(ref)
    floor = min(1.0, float(a.max()))
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(a, floor)), err.max()


def _norm(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref), \
        np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


# (name, B, heads, Sq, Sk, D, bias kind, causal, dropout): the MHA stacks'
# (B, 1, Sk) key padding with dropout, causal, a (B, Sq, Sk) bias with a
# dead row, ragged
FLASH_CASES = [
    ("mha_key_pad_dropout", 2, 2, 24, 24, 16, "key_pad", False, 0.1),
    ("causal", 2, 2, 24, 24, 16, "zeros", True, 0.0),
    ("full_bias_dead", 2, 2, 16, 24, 16, "dead", False, 0.0),
    ("ragged_causal_dropout", 1, 2, 40, 72, 32, "key_pad", True, 0.1),
]


def _flash_inputs(B, heads, sq, sk, d, kind, seed):
    rng = np.random.default_rng(seed)
    bh = B * heads
    q = (rng.standard_normal((bh, sq, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    do = rng.standard_normal((bh, sq, d)).astype(np.float32)
    if kind == "zeros":
        bias = np.zeros((1, 1, sk), np.float32)
    elif kind == "key_pad":
        bias = np.zeros((B, 1, sk), np.float32)
        for b in range(B):
            bias[b, 0, sk - 3 - b:] = pflash.NEG_INF
    else:
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
        bias[0, 3, :] = pflash.NEG_INF
    return q, k, v, do, bias


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_fp16_matches_pallas(case):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, _, bias = _flash_inputs(B, heads, sq, sk, d, kind, sq + sk)
    (jq, tq), (jk, tk), (jv, tv) = _h(q), _h(k), _h(v)
    j_out, j_lse = jflash._flash_fwd(jq, jk, jv, jnp.asarray(bias), causal,
                                     rate, 1234, heads)
    p_out, p_lse = pflash._flash_fwd(tq, tk, tv, torch.from_numpy(bias),
                                     causal, rate, 1234, heads)
    assert p_out.dtype == torch.float16 and j_out.dtype == jnp.float16
    assert p_lse.dtype == torch.float32
    _peak(p_out, j_out, OUT_TOL)
    # the fp32 lse at the fp32 forward's limit (tests/test_torch_flash.py)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_bwd_fp16_matches_pallas(case, fuse):
    """dq, dk, dv in fp16 from the JAX package's out and lse: the fused
    route, and the split route's dq and dk/dv kernels."""
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, do, bias = _flash_inputs(B, heads, sq, sk, d, kind, 3 * sq + d)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _h(q), _h(k), _h(v), _h(do)
    jb = jnp.asarray(bias)
    j_out, j_lse = jflash._flash_fwd(jq, jk, jv, jb, causal, rate, 77, heads)
    ref = jflash._flash_bwd(jq, jk, jv, jb, causal, rate, 77, heads, j_out,
                            j_lse, jdo, fuse=fuse)
    got = pflash._flash_bwd(tq, tk, tv, torch.from_numpy(bias), causal, rate,
                            77, heads, torch.from_numpy(np.array(j_out)),
                            torch.from_numpy(np.array(j_lse)), tdo,
                            fuse=fuse)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float16 and r.dtype == jnp.float16, name
        _norm(a, r, GRAD_TOL)


@pytest.mark.parametrize("w_dtype", ["float16", "float32", None])
@pytest.mark.parametrize("n,h", [(7, 40), (64, 1024), (3, 8192)])
def test_layer_norm_fp16_matches_pallas(n, h, w_dtype):
    """out (fp16) and the fp32 statistics, then dx (fp16), with fp16 or
    fp32 gamma / beta or none."""
    rng = np.random.default_rng(n + h)
    x = (rng.standard_normal((n, h)) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal((n, h)).astype(np.float32)
    (jx, tx), (jg, tg) = _h(x), _h(g)
    jw = jb = tw = tb = None
    if w_dtype is not None:
        w = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
        b = (rng.standard_normal(h) * 0.1).astype(np.float32)
        jw, jb = (jnp.asarray(a).astype(w_dtype) for a in (w, b))
        tw, tb = (torch.from_numpy(a).to(getattr(torch, w_dtype))
                  for a in (w, b))
    j_out, j_mean, j_inv = ln_fwd_pallas(jx, jw, jb, 1e-5)
    p_out, p_mean, p_inv = port_ln.ln_fwd(tx, tw, tb, 1e-5)
    assert p_out.dtype == torch.float16
    _scaled(p_out, j_out, OUT_TOL)
    np.testing.assert_allclose(p_mean.numpy(), np.asarray(j_mean),
                               atol=1e-5)
    np.testing.assert_allclose(p_inv.numpy(), np.asarray(j_inv), rtol=1e-5)
    j_dx = ln_bwd_pallas(jg, jx, j_mean, j_inv, jw, 1e-5)
    p_dx = port_ln.ln_bwd(tg, tx, torch.from_numpy(np.array(j_mean)),
                          torch.from_numpy(np.array(j_inv)), tw)
    assert p_dx.dtype == torch.float16
    _norm(p_dx, j_dx, GRAD_TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n,v", [(48, 256), (9, 1001)])
def test_xentropy_fp16_matches_pallas(n, v, smoothing):
    """fp16 logits: the fp32 loss and lse of the forward, then the fp16
    gradient of the summed loss (the JAX package's ``half_to_float=False``
    gives it in the logits' dtype, as autograd does here)."""
    rng = np.random.default_rng(n + v)
    x = (rng.standard_normal((n, v)) * 3.0).astype(np.float32)
    labels = rng.integers(0, v, n)
    labels[::4] = 0                                  # padding rows
    jx, tx = _h(x)
    jl, tl = jnp.asarray(labels), torch.from_numpy(labels)
    j_loss, j_lse = jxent._xent_fwd_pallas(jx, jl, smoothing)
    p_loss, p_lse = pxent._xent_fwd(tx, tl, smoothing)
    assert p_loss.dtype == torch.float32 and p_lse.dtype == torch.float32
    np.testing.assert_allclose(p_loss.numpy(), np.asarray(j_loss)[:n],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse)[:n],
                               rtol=1e-5, atol=1e-5)
    j_grad = jax.grad(lambda a: jxent.softmax_xentropy_loss(
        a, jl, smoothing).sum())(jx)
    tx.requires_grad_(True)
    pxent.softmax_xentropy_loss(tx, tl, smoothing).sum().backward()
    assert tx.grad.dtype == torch.float16 and j_grad.dtype == jnp.float16
    _norm(tx.grad, j_grad, GRAD_TOL)


@pytest.mark.parametrize("n", [131072, 3 * 131072])   # whole flat chunks
def test_l2norm_fp16_matches_pallas(n):
    rng = np.random.default_rng(n)
    jx, tx = _h(rng.standard_normal(n).astype(np.float32) * 5.0)
    ref = float(jkernels.multi_tensor_l2norm(jx))
    got = pkernels.multi_tensor_l2norm(tx)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - ref) <= 1e-5 * ref


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_fp16_model_copy_matches_pallas(adam_w_mode):
    n = 128 * 1024
    rng = np.random.default_rng(3)
    g, p, m = (rng.standard_normal(n).astype(np.float32) * s
               for s in (3.0, 1.0, 0.1))
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    scal = np.array([[1e-2, 0.9, 0.999, 1e-8, 0.01, 1 / (1 - 0.9 ** 3),
                      1 / (1 - 0.999 ** 3), 0.7]], np.float32)
    ref = jkernels.fused_adam_flat(*(jnp.asarray(a) for a in (g, p, m, v)),
                                   jnp.asarray(scal),
                                   adam_w_mode=adam_w_mode,
                                   model_dtype=jnp.float16)
    got = pkernels.fused_adam_flat(*(torch.from_numpy(a) for a in
                                     (g, p, m, v)), torch.from_numpy(scal),
                                   adam_w_mode=adam_w_mode,
                                   model_dtype=torch.float16)
    assert len(got) == len(ref) == 4
    assert got[3].dtype == torch.float16 and ref[3].dtype == jnp.float16
    for name, a, r in zip(("p", "m", "v"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(_np(got[3]), _np(ref[3]), rtol=1e-3,
                               atol=1e-7)


def _wrapper_checks(dt):
    """Each kernel wrapper's dtype check, on CPU tensors of ``dt``."""
    x = torch.zeros(4, 64, dtype=dt)
    q = torch.zeros(2, 8, 64, dtype=dt)
    return {
        "flash": lambda: pflash._check_cuda_inputs(
            q, q, q, torch.zeros(1, 1, 8), 0.0),
        "flash_launch_args": lambda: pflash._launch_args(
            q, q, torch.zeros(1, 1, 8), False, 0.0, 0, 1),
        "ln_x": lambda: port_ln._check_cuda_inputs(x, None, None),
        "ln_weight": lambda: port_ln._check_param(
            torch.ones(64, dtype=dt), "weight", torch.zeros(4, 64)),
        "xent": lambda: pxent._check_cuda_inputs(
            x, torch.zeros(4, dtype=torch.long)),
        "l2norm": lambda: pkernels._check_l2norm_input(
            torch.zeros(256, dtype=dt)),
        "adam_model_copy": lambda: pkernels._copy_code(dt),
    }


@pytest.mark.parametrize("wrapper", ["flash", "flash_launch_args", "ln_x",
                                     "ln_weight", "xent", "l2norm",
                                     "adam_model_copy"])
def test_wrappers_take_fp16_and_refuse_float64(wrapper, monkeypatch):
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    before = dict(build.LAUNCHES)
    _wrapper_checks(torch.float16)[wrapper]()
    with pytest.raises(TypeError, match="float64"):
        _wrapper_checks(torch.float64)[wrapper]()
    assert dict(build.LAUNCHES) == before
    assert port_ln.MAX_H[torch.float16] == 8192
