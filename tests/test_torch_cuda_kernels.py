"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets up the JAX package's CPU
mesh).  An element passes when ``|kernel - plain| <= tol * max(1,
|plain|)``: fp32 tol 1e-5 (layer-norm forward, cross-entropy) / 1e-4
(flash, layer-norm backward); bf16 tol 2e-2, since both versions round one
fp32 value and may land on neighbouring bf16 numbers, 2^-8 apart relative
to the value.  The l2norm is held to 1e-5 relative and must repeat bit for
bit.
"""
import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.multihead_attn import flash as pflash
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.utils import build

from _torch_port import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _close(got, ref, tol):
    err = (got.float() - ref.float()).abs()
    return bool((err <= tol * ref.float().abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,h", [(512, 1024), (8, 1024), (33, 4096),
                                 (5, 40)])
def test_ln_fwd_kernel_matches_plain(n, h, affine, dtype, cuda_device):
    rng = np.random.default_rng(n + h)
    tdt = getattr(torch, dtype)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, tdt)

    x = t((n, h)) * 2.0 + 0.5
    w, b = (t((h,)), t((h,))) if affine else (None, None)
    before = build.LAUNCHES["ln_fwd"]
    out, mean, inv = port_ln.ln_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ln_fwd"] == before + 1
    r_out, r_mean, r_inv = port_ln.ln_fwd_reference(x, w, b, 1e-5)
    assert _close(out, r_out, 1e-5 if dtype == "float32" else 2e-2)
    assert (mean - r_mean).abs().max().item() <= 1e-5
    assert ((inv - r_inv).abs() / r_inv.abs()).max().item() <= 1e-4


# (name, B, heads, Sq, Sk, D, bias kind, causal, dropout)
FLASH_CASES = [
    ("serving", 1, 16, 512, 512, 64, "zeros", True, 0.0),
    ("bidirectional", 2, 2, 96, 96, 64, "zeros", False, 0.0),
    ("key_pad_ragged", 2, 3, 100, 77, 32, "key_pad", False, 0.0),
    ("full_bias_dead", 2, 2, 64, 130, 128, "dead", False, 0.0),
    ("ragged_causal", 1, 4, 130, 70, 64, "zeros", True, 0.0),
    ("dropout", 2, 2, 128, 128, 64, "key_pad", True, 0.1),
]


def _flash_inputs(B, heads, sq, sk, d, kind, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    bh = B * heads

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dtype)

    q, k, v = t((bh, sq, d), d ** -0.5), t((bh, sk, d)), t((bh, sk, d))
    if kind == "zeros":
        bias = np.zeros((1, 1, sk), np.float32)
    elif kind == "key_pad":
        bias = np.zeros((B, 1, sk), np.float32)
        for b in range(B):
            bias[b, 0, sk - 5 - b:] = -1e9
    else:
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
        bias[0, 3, :] = pflash.NEG_INF
    return q, k, v, torch.from_numpy(bias).to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_kernel_matches_plain(case, dtype, cuda_device):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, cuda_device,
                                  getattr(torch, dtype), seed=sq + sk)
    before = build.LAUNCHES["flash_fwd"]
    out, lse = pflash._flash_fwd(q, k, v, bias, causal, rate, 99, heads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before + 1
    r_out, r_lse = pflash._reference(q, k, v, bias, causal, rate, 99, heads)
    assert _close(out, r_out, 1e-4 if dtype == "float32" else 2e-2)
    live = r_lse < 1e29
    assert _close(lse[live], r_lse[live], 1e-4)
    assert bool((lse[~live] == r_lse[~live]).all())
    assert bool((out[(~live)[..., 0]] == 0).all())


def test_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros(4, 60, device=cuda_device)          # H % 8 != 0
    with pytest.raises(ValueError):
        port_ln.ln_fwd(x, None, None, 1e-5)
    q = torch.zeros(2, 8, 48, device=cuda_device)       # unsupported D
    with pytest.raises(ValueError):
        pflash._flash_fwd(q, q, q, torch.zeros(1, 1, 8, device=cuda_device),
                          False, 0.0, 0, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,h", [(4096, 1024), (8, 1024), (33, 4096),
                                 (5, 40)])
def test_ln_bwd_kernel_matches_plain(n, h, affine, dtype, cuda_device):
    rng = np.random.default_rng(n * h)
    tdt = getattr(torch, dtype)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, tdt)

    x, g = t((n, h)) * 2.0 + 0.5, t((n, h))
    w = t((h,)) if affine else None
    _, mean, inv = port_ln.ln_fwd_reference(x, w, w, 1e-5)
    before = build.LAUNCHES["ln_bwd"]
    dx = port_ln.ln_bwd(g, x, mean, inv, w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ln_bwd"] == before + 1
    ref = port_ln.ln_bwd_reference(g, x, mean, inv, w)
    assert dx.dtype == tdt
    assert _close(dx, ref, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n,v", [(4096, 30592), (7, 1001), (3, 8)])
def test_xent_fwd_kernel_matches_plain(n, v, smoothing, dtype, cuda_device):
    from apex_tpu_torch.contrib.xentropy import softmax_xentropy as xent
    rng = np.random.default_rng(n + v)
    logits = torch.from_numpy((rng.standard_normal((n, v)) * 3).astype(
        np.float32)).to(cuda_device, getattr(torch, dtype))
    labels = torch.from_numpy(rng.integers(0, v, n)).to(cuda_device)
    labels[::5] = -1                                     # padding rows
    before = build.LAUNCHES["xent_fwd"]
    loss, lse = xent._xent_fwd(logits, labels, smoothing)
    torch.cuda.synchronize()
    assert build.LAUNCHES["xent_fwd"] == before + 1
    r_loss, r_lse = xent._xent_fwd_reference(logits, labels, smoothing)
    assert _close(lse, r_lse, 1e-5) and _close(loss, r_loss, 1e-5)


@pytest.mark.parametrize("dtype,n", [("float32", 1 << 20),
                                     ("bfloat16", 1_310_720),
                                     ("float32", 1001), ("bfloat16", 7)])
def test_l2norm_kernel_matches_plain_and_repeats(dtype, n, cuda_device):
    from apex_tpu_torch.multi_tensor_apply import kernels
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda_device, getattr(torch, dtype))
    before = build.LAUNCHES["l2norm"]
    a = kernels.multi_tensor_l2norm(x)
    b = kernels.multi_tensor_l2norm(x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["l2norm"] == before + 2
    assert a.shape == () and a.dtype == torch.float32
    assert torch.equal(a, b)                             # deterministic
    ref = kernels.multi_tensor_l2norm_reference(x)
    assert abs(a.item() - ref.item()) <= 1e-5 * ref.item()


# (name, B, heads, Sq, Sk, D, bias kind, causal, dropout)
FLASH_BWD_CASES = [
    ("training", 8, 16, 512, 512, 64, "zeros", False, 0.0),
    ("causal", 2, 2, 192, 192, 64, "zeros", True, 0.0),
    ("key_pad_ragged", 2, 3, 100, 77, 32, "key_pad", False, 0.0),
    ("full_bias_dead", 2, 2, 64, 130, 128, "dead", False, 0.0),
    ("ragged_causal", 1, 4, 130, 70, 64, "zeros", True, 0.0),
    ("dropout", 2, 2, 128, 128, 64, "key_pad", True, 0.1),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=[c[0] for c in FLASH_BWD_CASES])
def test_flash_bwd_kernel_matches_plain(case, dtype, cuda_device):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    tdt = getattr(torch, dtype)
    q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, cuda_device,
                                  tdt, seed=sq * sk)
    rng = np.random.default_rng(d)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(cuda_device, tdt)
    out, lse = pflash._flash_fwd(q, k, v, bias, causal, rate, 7, heads)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    before = build.LAUNCHES["flash_bwd"]
    got = pflash._flash_bwd_fused(q, k, v, bias, causal, rate, 7, heads, lse,
                                  delta, do)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_bwd"] == before + 1
    ref = pflash._flash_bwd_reference(q, k, v, bias, causal, rate, 7, heads,
                                      lse, delta, do)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == tdt and a.shape == r.shape, name
        assert _close(a, r, tol), (name, float((a.float() - r.float())
                                               .abs().max()))
    if dtype == "float32":
        # the whole kernel pipeline against autograd of the plain forward:
        # the backward regenerates the forward's dropout mask
        xla = pflash._xla_bwd(q, k, v, bias, causal, rate, 7, heads, do)
        for a, r in zip(got, xla):
            assert _close(a, r, 1e-4)


def test_flash_split_route_raises_on_the_card(cuda_device):
    q = torch.zeros(2, 8, 64, device=cuda_device)
    bias = torch.zeros(1, 1, 8, device=cuda_device)
    out, lse = pflash._flash_fwd(q, q, q, bias, False, 0.0, 0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pflash._flash_bwd(q, q, q, bias, False, 0.0, 0, 1, out, lse, q,
                          fuse=False)
