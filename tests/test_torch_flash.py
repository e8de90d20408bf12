"""Flash-attention forward of the PyTorch port against the JAX package.

The same numpy inputs go to ``apex_tpu``'s ``_flash_fwd`` (the Pallas
kernel, in interpret mode on the CPU) and to the port's ``_flash_fwd``,
which on a CPU tensor takes its plain version; out and lse are compared.
fp32 tolerance 2e-5: the kernel's blockwise online softmax and the plain
full-row softmax sum in different orders.  The dropout hash is compared bit
for bit.  The CUDA kernel itself is compared with the plain version on the
card by ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.contrib.multihead_attn import flash as jflash

from apex_tpu_torch.contrib.multihead_attn import flash as pflash

TOL = 2e-5

# (name, B, heads, Sq, Sk, D, bias kind, causal, dropout)
CASES = [
    ("causal", 2, 2, 24, 24, 16, "zeros", True, 0.0),
    ("bidirectional", 2, 2, 24, 24, 16, "zeros", False, 0.0),
    ("key_padding", 2, 3, 20, 20, 8, "key_pad", False, 0.0),
    ("key_padding_causal", 2, 3, 20, 20, 8, "key_pad", True, 0.0),
    ("full_bias", 2, 2, 16, 16, 16, "full", False, 0.0),
    ("ragged", 1, 2, 40, 72, 32, "key_pad", False, 0.0),
    ("ragged_causal", 1, 2, 72, 40, 32, "zeros", True, 0.0),
    ("dead_row", 2, 2, 16, 24, 16, "dead", False, 0.0),
    ("dropout", 2, 2, 24, 24, 16, "zeros", False, 0.1),
    ("dropout_causal_key_pad", 2, 2, 40, 40, 16, "key_pad", True, 0.1),
]


def _inputs(B, heads, sq, sk, d, kind, seed):
    rng = np.random.default_rng(seed)
    bh = B * heads
    q = (rng.standard_normal((bh, sq, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    if kind == "zeros":
        bias = np.zeros((1, 1, sk), np.float32)
    elif kind == "key_pad":       # last keys of each batch row padded out
        bias = np.zeros((B, 1, sk), np.float32)
        for b in range(B):
            bias[b, 0, sk - 3 - b:] = -1e9
    elif kind == "full":
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
    else:                         # "dead": rows that see only -1e30 keys
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
        bias[0, 3, :] = pflash.NEG_INF
        bias[1, 0, :] = pflash.NEG_INF
    return q, k, v, bias


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_fwd_matches_pallas(case):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _inputs(B, heads, sq, sk, d, kind, seed=sq * sk + d)
    seed = 1234
    j_out, j_lse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(bias),
                                     causal, rate, seed, heads)
    p_out, p_lse = pflash._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(bias), causal, rate,
                                     seed, heads)
    assert p_out.shape == q.shape and p_lse.shape == (B * heads, sq, 1)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse),
                               atol=TOL, rtol=TOL)
    if kind == "dead":
        assert np.all(p_out.numpy()[0, 3] == 0.0)
        assert p_lse.numpy()[0, 3, 0] == -pflash.NEG_INF


def test_flash_attention_returns_out():
    q, k, v, bias = _inputs(1, 2, 16, 16, 8, "zeros", seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out = pflash.flash_attention(*args, seed=0, causal=True, heads=2)
    ref = jflash.flash_attention(*[jnp.asarray(a) for a in (q, k, v, bias)],
                                 seed=0, causal=True, heads=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
@pytest.mark.parametrize("bh", [0, 5, 31])
@pytest.mark.parametrize("row0,col0", [(0, 0), (2 ** 31 - 4, 17),
                                       (123, 2 ** 31 - 6),
                                       (2 ** 31 - 2, 2 ** 31 - 3)])
def test_dropout_keep_bit_exact(seed, bh, row0, col0):
    shape = (8, 8)
    for rate in (0.1, 0.5, 0.9):
        ref = jflash._dropout_keep(jnp.int32(seed), jnp.int32(bh), row0, col0,
                                   shape, rate)
        got = pflash._dropout_keep(seed, bh, row0, col0, shape, rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dropout_keep_rate_is_honest():
    keep = pflash._dropout_keep(11, torch.arange(4)[:, None, None], 0, 0,
                                (64, 64), 0.25)
    assert keep.shape == (4, 64, 64)
    assert abs(keep.mean().item() - 0.75) < 0.02


@pytest.mark.parametrize("bad", ["bias_batch", "heads", "bias_rows", "kv"])
def test_layout_errors(bad):
    q = torch.zeros(4, 8, 16)
    k = v = torch.zeros(4, 8, 16)
    bias, heads = torch.zeros(1, 1, 8), 2
    if bad == "bias_batch":
        bias = torch.zeros(3, 1, 8)
    elif bad == "heads":
        heads = 3
    elif bad == "bias_rows":
        bias = torch.zeros(1, 5, 8)
    else:
        v = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError):
        pflash._flash_fwd(q, k, v, bias, False, 0.0, 0, heads)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "bias_dtype", "rate"])
def test_kernel_input_checks(bad):
    """The checks the CUDA wrapper applies before a launch."""
    q = k = v = torch.zeros(2, 8, 64)
    bias, rate = torch.zeros(1, 1, 8), 0.0
    if bad == "head_dim":
        q = k = v = torch.zeros(2, 8, 48)
    elif bad == "dtype":
        q = k = v = torch.zeros(2, 8, 64, dtype=torch.float16)
    elif bad == "bias_dtype":
        bias = bias.double()
    else:
        rate = 1.0
    with pytest.raises((ValueError, TypeError)):
        pflash._check_cuda_inputs(q, k, v, bias, rate)


def test_kernel_refuses_grad():
    q = torch.zeros(2, 8, 64, requires_grad=True)
    k = v = torch.zeros(2, 8, 64)
    with pytest.raises(RuntimeError, match="training slice"):
        pflash._check_cuda_inputs(q, k, v, torch.zeros(1, 1, 8), 0.0)
