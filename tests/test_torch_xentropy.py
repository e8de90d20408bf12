"""Softmax cross-entropy of the PyTorch port against the JAX package.

The same numpy logits and labels go to ``apex_tpu``'s ``_xent_fwd_pallas``
(the Pallas kernel, in interpret mode on the CPU) and ``_xent_fwd_xla``,
and to the port's ``_xent_fwd``, which on a CPU tensor returns its plain
version's own result (held by identity, one computation); the port's autograd gradient is held to ``jax.grad`` of
``softmax_xentropy_loss``.  fp32 tolerance 1e-5 (log-sum-exp over the
vocabulary in blocks against whole rows).  Padding rows (label =
padding_idx) give 0 loss and 0 gradient; their raw forward values are not
compared (the JAX XLA path wraps a label of -1 to the last column).  The
kernel itself is compared with the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.xentropy import softmax_xentropy as jx

from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             softmax_xentropy_loss)
from apex_tpu_torch.contrib.xentropy import softmax_xentropy as px

TOL = 1e-5


def _inputs(n, v, padding_idx, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * 3.0).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int64)
    labels[::4] = padding_idx
    return logits, labels


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n,v", [(16, 512), (9, 500), (3, 1030)])
def test_xent_fwd_matches_pallas_and_xla(n, v, smoothing, monkeypatch):
    logits, labels = _inputs(n, v, -1, seed=n + v)
    live = labels != -1
    j_pl = jx._xent_fwd_pallas(jnp.asarray(logits), jnp.asarray(labels),
                               smoothing)
    j_xla = jx._xent_fwd_xla(jnp.asarray(logits), jnp.asarray(labels),
                             smoothing)
    # on a CPU tensor the wrapper returns its plain version's own result:
    # held by identity, the one computation, not by a second evaluation
    calls = []
    plain = px._xent_fwd_reference

    def spy(*args):
        calls.append(plain(*args))
        return calls[-1]

    monkeypatch.setattr(px, "_xent_fwd_reference", spy)
    loss, lse = px._xent_fwd(torch.from_numpy(logits),
                             torch.from_numpy(labels), smoothing)
    assert len(calls) == 1
    assert calls[0][0] is loss and calls[0][1] is lse
    assert loss.shape == (n,) and lse.dtype == torch.float32
    for ref_loss, ref_lse in (j_pl, j_xla):
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(loss.numpy()[live],
                                   np.asarray(ref_loss)[live], atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("padding_idx", [0, -1])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grad_match_jax(smoothing, padding_idx, impl):
    n, v = 12, 300
    logits, labels = _inputs(n, v, padding_idx, seed=7)
    g = np.random.default_rng(1).standard_normal(n).astype(np.float32)

    def jloss(x):
        out = jx.softmax_xentropy_loss(x, jnp.asarray(labels), smoothing,
                                       padding_idx, False, impl)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), j_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    out = softmax_xentropy_loss(x, torch.from_numpy(labels), smoothing,
                                padding_idx, False, impl)
    (grad,) = torch.autograd.grad(out, [x], torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=TOL,
                               rtol=TOL)
    pad = labels == padding_idx
    assert np.all(out.detach().numpy()[pad] == 0.0)
    assert np.all(grad.numpy()[pad] == 0.0)


def test_apply_mirrors_the_function_and_bf16_grad_dtype():
    logits, labels = _inputs(6, 64, 0, seed=3)
    x = torch.from_numpy(logits).bfloat16().requires_grad_(True)
    out = SoftmaxCrossEntropyLoss.apply(x, torch.from_numpy(labels), 0.1, 0,
                                        True)
    ref = softmax_xentropy_loss(x, torch.from_numpy(labels), 0.1, 0, True)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out.sum().backward()
    assert x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["label_range", "impl"])
def test_bad_labels_and_impl_raise(bad):
    logits = torch.zeros(4, 10)
    labels = torch.tensor([1, 2, 3, 4])
    impl = "auto"
    if bad == "label_range":
        labels = torch.tensor([1, 10, 3, -2])
    else:
        impl = "cuda"
    with pytest.raises(ValueError):
        softmax_xentropy_loss(logits, labels, 0.0, -1, False, impl)


def test_int32_labels_accepted():
    logits, labels = _inputs(5, 40, 0, seed=9)
    a = softmax_xentropy_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels).int(), 0.1, 0)
    b = softmax_xentropy_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels), 0.1, 0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# (V, dtype) -> instance, by the 16-byte vectors a row spans: 8 lanes a
# row holding 1, 2 or 4 a lane up to 8, 16, 32; 16 lanes holding 4 up to
# 64; 32 lanes up to 128 (2 KB); the shared-memory ring past that;
# unaligned widths count their vectors rounded up (a scalar head and tail
# take the rest)
XENT_PLAN_CASES = [
    (256, "float16", "lanes8x4"), (256, "bfloat16", "lanes8x4"),
    (256, "float32", "lanes16x4"), (64, "float16", "lanes8x1"),
    (64, "float32", "lanes8x2"), (8, "float32", "lanes8x1"),
    (255, "float16", "lanes8x4"), (257, "float16", "lanes16x4"),
    (257, "float32", "lanes32x4"), (500, "float32", "lanes32x4"),
    (1001, "bfloat16", "lanes32x4"), (1024, "float16", "lanes32x4"),
    (1025, "float16", "wide"), (1025, "float32", "wide"),
    (30592, "bfloat16", "wide"), (50257, "float16", "wide"),
]


@pytest.mark.parametrize("n", [1, 4096, 32768])
@pytest.mark.parametrize("v,dtype,want", XENT_PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in XENT_PLAN_CASES])
def test_xent_plan_pins_instances(v, dtype, want, n):
    """The instance depends on the row alone, not on N."""
    assert px._xent_plan(v, getattr(torch, dtype)) == want
    assert want in px.XENT_PATHS
    logits = torch.zeros(n, v, dtype=getattr(torch, dtype))
    px._check_cuda_inputs(logits, torch.zeros(n, dtype=torch.long))


def test_unaligned_logits_pass_the_checks():
    """A contiguous view whose rows start off 16 bytes is taken (the kernel
    reads a scalar head and tail around each row's aligned body)."""
    flat = torch.zeros(3 * 255 + 1, dtype=torch.float16)
    logits = flat[1:].view(3, 255)
    assert logits.data_ptr() % 16
    labels, code = px._check_cuda_inputs(logits, torch.zeros(3,
                                                             dtype=torch.int32))
    assert labels.dtype == torch.int64 and code == 2
