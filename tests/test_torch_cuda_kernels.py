"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets up the JAX package's CPU
mesh).  An element passes when ``|kernel - plain| <= tol * max(1,
|plain|)``: fp32 tol 1e-5 (layer-norm forward, cross-entropy) / 1e-4
(flash, layer-norm backward); bf16 tol 2e-2, since both versions round one
fp32 value and may land on neighbouring bf16 numbers, 2^-8 apart relative
to the value.  Attention's outputs and the flash backward's gradients may
lie far below 1, so for them the floor of 1 drops to the tensor's largest
|plain|.  The l2norm is held to 1e-5 relative and must repeat bit for
bit.  The Adam and LAMB stage-1 kernels are held to 1e-6 relative (both
versions do the same IEEE operations in the same order).  The split
flash backward's dq and dk/dv kernels take the fused kernel's
tolerances; the fused and dk/dv kernels, one template, must give the same
dk and dv bits, and the fused kernel's (BH, ceil(Sk / 128), Sq, D) dq
partials must fill their buffer and sum to its dq bit for bit.  The ZeRO LAMB step on a world-1 NCCL group must give the same
bits twice (its trust ratios sum in a fixed order), and a CUDA tensor on a
gloo group must raise.  The scale and axpby kernels must give the plain
versions' bits (the same IEEE products and sums, the same rounding into
the output type) and the same overflow flag.  The fused dense kernel is
held per element to ``tol * max(1, |plain|)``: fp32 1e-5 (SIMT fmaf, sums
in another order than cuBLAS), bf16 2e-2 and fp16 4e-3 (both versions
round one fp32 value whose sums ran in other orders, and may land on
neighbouring 16-bit numbers; fp16's 2^-11 steps plus a K-long sum's
rounding); its TMA + wgmma route must repeat bit for bit.  The fp16
instances of the flash, layer-norm, cross-entropy, l2norm and Adam-copy
kernels: an output within 5e-3 (fp16's steps are 2^-11 relative: both
versions round one fp32 value and may land on neighbouring fp16 numbers),
on the peak rule for attention; a gradient (flash dq / dk / dv,
layer-norm dx) within 2e-3 relative in norm, since its small elements
carry the cancellation of rounded products; fp32 results of fp16 inputs
(lse, the loss, the l2 norm) at their fp32 limits; the fp16 model copy
within 1e-3 relative (one fp16 step of the fp32 update, which is held to
1e-6).  Every kernel refuses a float64 CUDA tensor with a ``TypeError``
and launches nothing.
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


def _peak_close(got, ref, tol):
    """A gradient's limit: ``_close`` with its floor of 1 lowered to the
    tensor's largest |value| (gradients may lie far below 1, where a floor
    of 1 would be loose)."""
    err = (got.float() - ref.float()).abs()
    a = ref.float().abs()
    return bool((err <= tol * a.clamp(min=min(1.0, float(a.max())))).all())


def _norm_close(got, ref, tol):
    """|got - ref| <= tol |ref| in norm (an all-zero ref: got exactly 0)."""
    diff = float((got.float() - ref.float()).norm())
    return diff <= tol * float(ref.float().norm())


#: the fp16 instances' limits (the module docstring)
FP16_OUT_TOL, FP16_GRAD_TOL = 5e-3, 2e-3


#: layer-norm widths off the 16-byte vector and past the register paths
#: (the wide path staged in shared memory, and re-read at 65,536)
LN_EDGE_SHAPES = [(7, 33), (9, 60), (64, 1000), (16, 12288), (4, 65536)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,h", [(512, 1024), (8, 1024), (33, 4096),
                                 (5, 40)] + LN_EDGE_SHAPES)
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
    assert _close(out, r_out, {"float32": 1e-5, "bfloat16": 2e-2,
                               "float16": FP16_OUT_TOL}[dtype])
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

# The edges of the bf16 kernels' tiles (128 keys a forward stage, 64 a dq
# stage, 64 or 128 query rows a CTA, 132+ CTAs of 128 rows taking the
# two-warpgroup kernels; 128 keys a CTA and 64 query rows a stage of the
# fused and dk/dv kernels), each bias shape with a dead row, dropout, D = 32
# and 128.
FLASH_EDGE_CASES = [
    ("s1", 1, 2, 1, 1, 64, "zeros", False, 0.0),
    ("s127_causal", 1, 2, 127, 127, 64, "shared_pad", True, 0.0),
    ("s129", 2, 2, 129, 129, 64, "key_dead", False, 0.0),
    ("s200x333", 2, 2, 200, 333, 64, "dead", False, 0.0),
    ("sk_below_tile", 2, 2, 100, 40, 64, "shared_pad", False, 0.0),
    ("sk_one_dq_tile", 2, 2, 130, 64, 64, "key_dead", False, 0.0),
    ("sk_one_fwd_tile", 2, 2, 130, 128, 64, "key_pad", False, 0.0),
    ("causal_sq_lt_sk", 2, 2, 200, 333, 64, "key_dead", True, 0.0),
    ("causal_sq_gt_sk", 2, 2, 333, 200, 64, "dead", True, 0.0),
    ("all_dead", 1, 2, 64, 96, 64, "all_dead", False, 0.0),
    ("dropout_full_bias", 2, 2, 129, 200, 64, "dead", True, 0.1),
    ("d32_dropout", 2, 2, 127, 129, 32, "key_dead", True, 0.1),
    ("d128_ragged", 2, 2, 200, 333, 128, "dead", False, 0.0),
    ("wide_ragged", 2, 66, 200, 333, 64, "dead", True, 0.1),
    ("wide_d32", 2, 66, 127, 100, 32, "shared_pad", True, 0.0),
    ("wide_d128", 2, 66, 129, 129, 128, "key_dead", False, 0.0),
    # Sk one under, at and one over a 128-key tile and one under two; Sq
    # under one 64-row stage, at one and one row over; causal with Sq != Sk
    # across a 128-key tile's diagonal; D = 32 and 128 with dropout
    ("sk127_sq64", 2, 2, 64, 127, 64, "dead", False, 0.0),
    ("sk128_sq40", 2, 2, 40, 128, 64, "key_dead", False, 0.0),
    ("sk129_sq65", 2, 2, 65, 129, 64, "key_pad", False, 0.0),
    ("sk255_causal", 2, 2, 65, 255, 64, "key_dead", True, 0.0),
    ("causal_sq300_sk130", 2, 2, 300, 130, 64, "dead", True, 0.0),
    ("causal_sq130_sk300", 2, 2, 130, 300, 64, "shared_pad", True, 0.0),
    ("d32_dropout_sk255", 2, 2, 130, 255, 32, "dead", True, 0.1),
    ("d128_dropout_sk129", 2, 2, 65, 129, 128, "key_dead", True, 0.1),
    # a (1, Sq, Sk) bias (the attention modules' non-causal time mask),
    # with a dead row: square at the MHA width, ragged, and with dropout
    ("time_mask_mha", 2, 16, 64, 64, 64, "time", False, 0.1),
    ("time_mask_ragged", 2, 2, 129, 200, 64, "time", False, 0.0),
    ("time_mask_causal", 2, 3, 200, 130, 32, "time", True, 0.1),
    # rows whose every visible key carries -1e9 (the backward rebuilds P
    # from the forward's (m, log l)): a (1, Sq, Sk) bias, with and without
    # a causal mask, dropout, and the two-warpgroup kernels
    ("masked_rows", 2, 2, 129, 200, 64, "masked", False, 0.0),
    ("masked_rows_causal", 2, 2, 200, 130, 64, "masked", True, 0.1),
    ("masked_rows_wide", 2, 66, 129, 129, 64, "masked", True, 0.0),
    ("masked_rows_d128", 2, 66, 129, 129, 128, "masked", True, 0.0),
]
#: cases whose bf16 gradients are held to 2e-2 relative in norm, not on the
#: peak rule: rows with three visible keys give dS near |dP|, which grows
#: as sqrt(D); the kernels and the plain version round dS to bf16 and may
#: land on neighbouring numbers (up to 2^-7 apart relative), which moves an
#: element of dq by up to 2^-7 sum_j |dS_j| |k_j|, past the peak rule's
#: 2e-2 on a value near 1 at D = 128
NORM_RULE_CASES = {"masked_rows_d128"}
# head dims between the kernel instances: padded to 64, 128 and 256 in the
# wrappers and sliced back, on the forward and both backward routes; D =
# 256 itself (the scalar kernels in every dtype); D 320 and 512
FLASH_PAD_CASES = [
    ("d48_dropout", 2, 2, 130, 200, 48, "key_pad", True, 0.1),
    ("d48_dead", 2, 2, 64, 130, 48, "dead", False, 0.0),
    ("d96_ragged", 2, 3, 129, 129, 96, "key_dead", False, 0.0),
    ("d96_time_dropout", 2, 2, 200, 130, 96, "time", True, 0.1),
    ("d160_dropout", 2, 2, 130, 200, 160, "key_pad", True, 0.1),
    ("d192_dead", 2, 2, 64, 130, 192, "dead", False, 0.0),
    ("d256_ragged", 2, 3, 129, 129, 256, "key_dead", False, 0.0),
    ("d256_masked_causal", 2, 2, 200, 130, 256, "masked", True, 0.1),
    # past 256: the column-chunked kernels (D padded to a multiple of 128,
    # one CTA per 128-column chunk), ragged, dead and masked rows, dropout
    ("d320_masked_causal", 2, 2, 130, 200, 320, "masked", True, 0.1),
    ("d320_dead", 2, 2, 64, 130, 320, "dead", False, 0.0),
    ("d512_ragged", 2, 3, 129, 129, 512, "key_dead", False, 0.0),
    ("d512_time_dropout", 2, 2, 200, 130, 512, "time", True, 0.1),
]
FLASH_EDGE_CASES = FLASH_EDGE_CASES + FLASH_PAD_CASES
FLASH_CASES = FLASH_CASES + FLASH_EDGE_CASES


def _flash_inputs(B, heads, sq, sk, d, kind, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    bh = B * heads

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dtype)

    q, k, v = t((bh, sq, d), d ** -0.5), t((bh, sk, d)), t((bh, sk, d))
    if kind == "zeros":
        bias = np.zeros((1, 1, sk), np.float32)
    elif kind == "shared_pad":                 # (1, 1, Sk)
        bias = np.zeros((1, 1, sk), np.float32)
        bias[..., max(1, sk - 5):] = -1e9
    elif kind == "all_dead":                   # (1, 1, Sk): every row dead
        bias = np.full((1, 1, sk), pflash.NEG_INF, np.float32)
    elif kind == "time":                       # (1, Sq, Sk), a dead row
        bias = np.where(rng.random((1, sq, sk)) < 0.3, -1e9,
                        0.0).astype(np.float32)
        bias[0, sq // 2, :] = pflash.NEG_INF
    elif kind == "masked":                     # (1, Sq, Sk)
        # the first rows and every 7th: -1e9 on every key; every 5th past
        # its third key; the rest unmasked
        bias = np.zeros((1, sq, sk), np.float32)
        bias[0, 4::5, 3:] = -1e9
        bias[0, :4, :] = -1e9
        bias[0, ::7, :] = -1e9
    elif kind in ("key_pad", "key_dead"):      # (B, 1, Sk)
        bias = np.zeros((B, 1, sk), np.float32)
        for b in range(B):
            bias[b, 0, max(1, sk - 5 - b):] = -1e9
        if kind == "key_dead":                 # the last batch row's heads
            bias[B - 1] = pflash.NEG_INF
    else:                                      # (B, Sq, Sk)
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
        bias[0, 3, :] = pflash.NEG_INF
    return q, k, v, torch.from_numpy(bias).to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_kernel_matches_plain(case, dtype, cuda_device):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, cuda_device,
                                  getattr(torch, dtype), seed=sq + sk)
    before = build.LAUNCHES["flash_fwd"]
    out, lse, stats = pflash._flash_fwd_res(q, k, v, bias, causal, rate, 99,
                                            heads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before + 1
    r_out, r_lse, r_stats = pflash._reference_res(q, k, v, bias, causal,
                                                  rate, 99, heads)
    # the backward's residual: the row max and log l, kept apart
    live = r_lse[..., 0] < 1e29
    assert _close(stats[..., 0][live], r_stats[..., 0][live], 1e-4)
    assert bool((torch.abs(stats[..., 1] - r_stats[..., 1])[live]
                 <= 1e-3).all())
    assert torch.equal(stats[~live], r_stats[~live])
    assert _peak_close(out, r_out, {"float32": 1e-4, "bfloat16": 2e-2,
                                    "float16": FP16_OUT_TOL}[dtype])
    live = r_lse < 1e29
    assert _close(lse[live], r_lse[live], 1e-4)
    assert bool((lse[~live] == r_lse[~live]).all())
    assert bool((out[(~live)[..., 0]] == 0).all())


def test_wrappers_raise_instead_of_falling_back(cuda_device):
    """A CUDA tensor launches a kernel or raises: H = 60 (off the 16-byte
    vector) launches and matches the plain version; float64 and a
    non-contiguous q raise and launch nothing.  (A head dim past 256 once
    raised here; the chunked kernels take it now.)"""
    x = torch.randn(4, 60, device=cuda_device)          # H % 8 != 0
    before = build.LAUNCHES["ln_fwd"]
    out, mean, inv = port_ln.ln_fwd(x, None, None, 1e-5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ln_fwd"] == before + 1
    assert _close(out, port_ln.ln_fwd_reference(x, None, None, 1e-5)[0],
                  1e-5)
    launches = dict(build.LAUNCHES)
    with pytest.raises(TypeError):
        port_ln.ln_fwd(x.double(), None, None, 1e-5)
    bias = torch.zeros(1, 1, 8, device=cuda_device)
    q = torch.zeros(2, 64, 8, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pflash._flash_fwd(q, q, q, bias, False, 0.0, 0, 1)
    q = torch.zeros(2, 8, 48, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        pflash._flash_fwd(q, q, q, bias, False, 0.0, 0, 1)
    assert dict(build.LAUNCHES) == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("h", [1024, 33, 12288])
def test_ln_kernels_take_unaligned_views(h, affine, dtype, cuda_device):
    """x, g and the weight as views one element into their storage (2 or 4
    bytes off 16): the element-load paths, held as the aligned ones."""
    rng = np.random.default_rng(h)
    tdt = getattr(torch, dtype)
    n = 6

    def view(shape):
        flat = torch.from_numpy(rng.standard_normal(
            int(np.prod(shape)) + 1).astype(np.float32)).to(cuda_device, tdt)
        return flat[1:].view(shape)

    x, g, w, b = view((n, h)), view((n, h)), view((h,)), view((h,))
    x.mul_(2.0).add_(0.5)
    assert x.data_ptr() % 16 and g.data_ptr() % 16 and w.data_ptr() % 16
    if not affine:
        w = b = None
    before = dict(build.LAUNCHES)
    out, mean, inv = port_ln.ln_fwd(x, w, b, 1e-5)
    dx = port_ln.ln_bwd(g, x, mean, inv, w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ln_fwd"] == before.get("ln_fwd", 0) + 1
    assert build.LAUNCHES["ln_bwd"] == before.get("ln_bwd", 0) + 1
    r_out, r_mean, r_inv = port_ln.ln_fwd_reference(x, w, b, 1e-5)
    assert _close(out, r_out, {"float32": 1e-5, "bfloat16": 2e-2,
                               "float16": FP16_OUT_TOL}[dtype])
    assert (mean - r_mean).abs().max().item() <= 1e-5
    ref = port_ln.ln_bwd_reference(g, x, mean, inv, w)
    if dtype == "float16":
        assert _norm_close(dx, ref, FP16_GRAD_TOL)
    else:
        assert _close(dx, ref, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,h", [(4096, 1024), (8, 1024), (33, 4096),
                                 (5, 40), (7680, 1024)] + LN_EDGE_SHAPES)
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
    if dtype == "float16":
        assert _norm_close(dx, ref, FP16_GRAD_TOL)
    else:
        assert _close(dx, ref, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n,v", [(4096, 30592), (32768, 256), (7, 1001),
                                 (3, 8), (4096, 64), (1000, 255), (999, 257),
                                 (513, 1025), (64, 50257)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n,v", [(300, 256), (40, 30592)])
def test_xent_fwd_kernel_takes_an_unaligned_view(n, v, dtype, cuda_device):
    """Logits one element into their storage: every row's scalar head and
    tail around its aligned body, on the warp and ring instances."""
    from apex_tpu_torch.contrib.xentropy import softmax_xentropy as xent
    rng = np.random.default_rng(v)
    flat = torch.from_numpy((rng.standard_normal(n * v + 1) * 3).astype(
        np.float32)).to(cuda_device, getattr(torch, dtype))
    logits = flat[1:].view(n, v)
    assert logits.data_ptr() % 16
    labels = torch.from_numpy(rng.integers(0, v, n)).to(cuda_device)
    labels[::7] = -1
    before = build.LAUNCHES["xent_fwd"]
    loss, lse = xent._xent_fwd(logits, labels, 0.1)
    torch.cuda.synchronize()
    assert build.LAUNCHES["xent_fwd"] == before + 1
    r_loss, r_lse = xent._xent_fwd_reference(logits, labels, 0.1)
    assert _close(lse, r_lse, 1e-5) and _close(loss, r_loss, 1e-5)


@pytest.mark.parametrize("dtype,n", [("float32", 1 << 20),
                                     ("bfloat16", 1_310_720),
                                     ("float32", 1001), ("bfloat16", 7),
                                     ("float16", 25_296_896),
                                     ("float16", 1001)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES + FLASH_EDGE_CASES,
                         ids=[c[0] for c in FLASH_BWD_CASES + FLASH_EDGE_CASES])
def test_flash_bwd_kernel_matches_plain(case, dtype, cuda_device):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    tdt = getattr(torch, dtype)
    q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, cuda_device,
                                  tdt, seed=sq * sk)
    rng = np.random.default_rng(d)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(cuda_device, tdt)
    out, _, stats = pflash._flash_fwd_res(q, k, v, bias, causal, rate, 7,
                                          heads)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    before = build.LAUNCHES["flash_bwd"]
    got = pflash._flash_bwd_fused(q, k, v, bias, causal, rate, 7, heads,
                                  stats, delta, do)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_bwd"] == before + 1
    ref = pflash._flash_bwd_reference(q, k, v, bias, causal, rate, 7, heads,
                                      stats, delta, do)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == tdt and a.shape == r.shape, name
        # over a single key the softmax is constant: dq and dk are 0 up to
        # rounding, which the peak rule would hold to itself
        close = _close if sk == 1 and name != "dv" else _peak_close
        if dtype == "float16":
            close, tol = (_close, FP16_OUT_TOL) if sk == 1 and name != "dv" \
                else (_norm_close, FP16_GRAD_TOL)
        elif dtype == "bfloat16" and case[0] in NORM_RULE_CASES:
            close = _norm_close
        assert close(a, r, tol), (name, float((a.float() - r.float())
                                              .abs().max()))
    if dtype == "float32":
        # the whole kernel pipeline against autograd of the plain forward:
        # the backward regenerates the forward's dropout mask
        xla = pflash._xla_bwd(q, k, v, bias, causal, rate, 7, heads, do)
        for a, r in zip(got, xla):
            assert _close(a, r, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES + FLASH_EDGE_CASES,
                         ids=[c[0] for c in FLASH_BWD_CASES + FLASH_EDGE_CASES])
def test_flash_bwd_split_kernels_match_plain(case, dtype, cuda_device):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    tdt = getattr(torch, dtype)
    q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, cuda_device,
                                  tdt, seed=sq + 3 * sk)
    rng = np.random.default_rng(d + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(cuda_device, tdt)
    out, _, stats = pflash._flash_fwd_res(q, k, v, bias, causal, rate, 5,
                                          heads)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, bias, causal, rate, 5, heads, stats, delta, do)
    before = dict(build.LAUNCHES)
    dq = pflash._flash_bwd_dq(*args)
    dk, dv = pflash._flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_bwd_dq"] == before.get("flash_bwd_dq", 0) + 1
    assert build.LAUNCHES["flash_bwd_dkv"] == \
        before.get("flash_bwd_dkv", 0) + 1
    ref_dq = pflash._flash_bwd_dq_reference(*args)
    ref_dk, ref_dv = pflash._flash_bwd_dkv_reference(*args)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, r in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                       ("dv", dv, ref_dv)):
        assert a.dtype == tdt and a.shape == r.shape, name
        # over a single key the softmax is constant: dq and dk are 0 up to
        # rounding, which the peak rule would hold to itself
        close = _close if sk == 1 and name != "dv" else _peak_close
        if dtype == "float16":
            close, tol = (_close, FP16_OUT_TOL) if sk == 1 and name != "dv" \
                else (_norm_close, FP16_GRAD_TOL)
        elif dtype == "bfloat16" and case[0] in NORM_RULE_CASES:
            close = _norm_close
        assert close(a, r, tol), (name, float((a.float() - r.float())
                                              .abs().max()))
    if dtype == "float32":
        # dq, dk, dv against autograd of the plain forward: the split
        # kernels regenerate the forward's dropout mask too
        xla = pflash._xla_bwd(q, k, v, bias, causal, rate, 5, heads, do)
        for a, r in zip((dq, dk, dv), xla):
            assert _close(a, r, 1e-4)


@pytest.mark.parametrize("shape,nshape", [((64, 33), (33,)),
                                          ((6, 32, 16, 16), (32, 16, 16)),
                                          ((16, 12288), (12288,))],
                         ids=["h33", "32x16x16", "h12288"])
def test_fused_layer_norm_module_any_width_on_the_card(shape, nshape,
                                                       cuda_device):
    """``FusedLayerNorm`` at widths the kernels once refused, forward and
    backward on the card, fp32: one launch of each kernel, out 1e-5 and
    dx, dw, db 1e-4 against the same module on the CPU."""
    from apex_tpu_torch.normalization import FusedLayerNorm
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5
    g = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(nshape).astype(np.float32)
    b = rng.standard_normal(nshape).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        mod = FusedLayerNorm(nshape, device=dev)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(w))
            mod.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        before = dict(build.LAUNCHES)
        out = mod(xt)
        grads = torch.autograd.grad(out, [xt, mod.weight, mod.bias],
                                    torch.from_numpy(g).to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert build.LAUNCHES["ln_fwd"] == before.get("ln_fwd", 0) + 1
            assert build.LAUNCHES["ln_bwd"] == before.get("ln_bwd", 0) + 1
        outs[str(dev)] = [t.detach().cpu() for t in (out,) + grads]
    ref, got = outs["cpu"], outs[str(cuda_device)]
    assert _close(got[0], ref[0], 1e-5)
    for a, r in zip(got[1:], ref[1:]):
        assert _close(a, r, 1e-4)


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("d", [48, 96, 160, 200, 257, 400])
def test_flash_attention_odd_head_dims_on_the_card(d, route, cuda_device,
                                                   monkeypatch):
    """``flash_attention`` with its gradients at head dims the kernels are
    not built for: the forward and the chosen backward route launch once
    each, and out, dq, dk, dv match autograd of the plain forward (fp32,
    1e-4)."""
    if route == "split":
        monkeypatch.setattr(pflash, "_FUSE_BUFFER_CAP_MB", 0.0)
    q, k, v, bias = _flash_inputs(2, 2, 130, 200, d, "key_pad", cuda_device,
                                  torch.float32, seed=d)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)
                     ).to(cuda_device)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(build.LAUNCHES)
    out = pflash.flash_attention(*qkv, bias, seed=5, causal=True,
                                 dropout_rate=0.1, heads=2)
    grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    want = ({"flash_fwd": 1, "flash_bwd": 1} if route == "fused" else
            {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1})
    for name, n in want.items():
        assert build.LAUNCHES[name] == before.get(name, 0) + n, name
    r_out, _ = pflash._reference(q, k, v, bias, True, 0.1, 5, 2)
    assert out.shape == q.shape and _peak_close(out, r_out, 1e-4)
    for a, r in zip(grads, pflash._xla_bwd(q, k, v, bias, True, 0.1, 5, 2,
                                           do)):
        assert a.shape == r.shape and _close(a, r, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_past_65535_batch_heads(dtype, cuda_device):
    """BH = 65,536 (past gridDim.y's 65,535): the batch-heads ride the
    one-dimensional grid; out and lse match the plain version."""
    q, k, v, bias = _flash_inputs(4096, 16, 32, 32, 64, "zeros", cuda_device,
                                  getattr(torch, dtype), seed=65536)
    assert q.shape[0] == 65536
    before = build.LAUNCHES["flash_fwd"]
    out, lse = pflash._flash_fwd(q, k, v, bias, True, 0.1, 3, 16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before + 1
    r_out, r_lse = pflash._reference(q, k, v, bias, True, 0.1, 3, 16)
    assert _peak_close(out, r_out, 1e-4 if dtype == "float32" else 2e-2)
    assert _close(lse, r_lse, 1e-4)


def test_flash_split_route_runs_on_the_card(cuda_device):
    """``_flash_bwd`` with ``fuse=False`` launches the dq and dk/dv
    kernels, not the fused one, and gives the fused route's gradients: dk
    and dv bit for bit (one kernel template, one order of operations), dq
    on the peak rule (the fused route sums 128-key fp32 partials, the dq
    kernel one fp32 accumulator over 64-key stages)."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, 200, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(4))
    bias = torch.zeros(1, 1, 200, device=cuda_device)
    out, lse = pflash._flash_fwd(q, k, v, bias, True, 0.0, 0, 2)
    before = dict(build.LAUNCHES)
    split = pflash._flash_bwd(q, k, v, bias, True, 0.0, 0, 2, out, lse, do,
                              fuse=False)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_bwd"] == before.get("flash_bwd", 0)
    assert build.LAUNCHES["flash_bwd_dq"] == before.get("flash_bwd_dq", 0) + 1
    fused = pflash._flash_bwd(q, k, v, bias, True, 0.0, 0, 2, out, lse, do,
                              fuse=True)
    assert _peak_close(split[0], fused[0], 2e-2)
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2], fused[2])


def test_flash_kernels_capture_in_a_cuda_graph(cuda_device):
    """The bf16 forward, dq, fused and dk/dv kernels launch inside
    CUDA-graph capture (the shared-memory opt-in and the tensor maps are
    host work outside the stream): 3 calls of each captured, replayed,
    equal to eager calls bit for bit."""
    q, k, v, bias = _flash_inputs(2, 66, 200, 333, 64, "key_pad", cuda_device,
                                  torch.bfloat16, seed=4)
    rng = np.random.default_rng(4)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    out, lse = pflash._flash_fwd(q, k, v, bias, True, 0.1, 3, 66)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, bias, True, 0.1, 3, 66, lse, delta, do)
    dq = pflash._flash_bwd_dq(*args)
    fused = pflash._flash_bwd_fused(*args)
    dkv = pflash._flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [pflash._flash_fwd(q, k, v, bias, True, 0.1, 3, 66)[0]
               for _ in range(3)]
        got += [pflash._flash_bwd_dq(*args) for _ in range(3)]
        got_fused = [pflash._flash_bwd_fused(*args) for _ in range(3)]
        got_dkv = [pflash._flash_bwd_dkv(*args) for _ in range(3)]
    for t in got + [t for outs in got_fused + got_dkv for t in outs]:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for t in got[:3]:
        assert torch.equal(t, out)
    for t in got[3:]:
        assert torch.equal(t, dq)
    for outs in got_fused:
        assert all(torch.equal(a, b) for a, b in zip(outs, fused))
    for outs in got_dkv:
        assert all(torch.equal(a, b) for a, b in zip(outs, dkv))


@pytest.mark.parametrize("case", [c for c in FLASH_EDGE_CASES
                                  if c[0] in ("sk127_sq64", "sk255_causal",
                                              "causal_sq300_sk130",
                                              "d32_dropout_sk255",
                                              "d128_dropout_sk129",
                                              "d512_time_dropout")],
                         ids=lambda c: c[0])
def test_flash_bwd_partials_fill_their_buffer(case, cuda_device):
    """The fused kernel's dq partials are (BH, ceil(Sk / 128), Sq, D) fp32:
    a NaN-filled buffer of that shape comes back finite (every block
    written once, zeros where the causal mask skips a q tile) and sums to
    the wrapper's dq bit for bit."""
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, cuda_device,
                                  torch.bfloat16, seed=sq + sk + d)
    rng = np.random.default_rng(sk)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    out, _, stats = pflash._flash_fwd_res(q, k, v, bias, causal, rate, 9,
                                          heads)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, bias, causal, rate, 9, heads, stats, delta, do)
    dq, dk, dv = pflash._flash_bwd_fused(*args)
    assert pflash.BWD_K_TILE == 128
    nk = -(-sk // pflash.BWD_K_TILE)
    part = torch.full((B * heads, nk, sq, d), float("nan"),
                      device=cuda_device)
    pdk, pdv = torch.empty_like(k), torch.empty_like(v)
    err = build.library().apex_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), stats.data_ptr(), delta.data_ptr(), part.data_ptr(),
        pdk.data_ptr(), pdv.data_ptr(),
        *pflash._launch_args(q, k, bias, causal, rate, 9, heads))
    torch.cuda.synchronize()
    assert err == 0
    assert bool(torch.isfinite(part).all())
    assert torch.equal(part.sum(dim=1).to(q.dtype), dq)
    assert torch.equal(pdk, dk) and torch.equal(pdv, dv)
    if causal:
        for kt in range(nk):
            # q tiles of 64 rows wholly above the key tile: zeros
            rows = min(kt * pflash.BWD_K_TILE // 64 * 64, sq)
            assert bool((part[:, kt, :rows] == 0).all())


def _update_buffers(n, dev, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32) * 3.0
    p = rng.standard_normal(n).astype(np.float32)
    m = rng.standard_normal(n).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    return [torch.from_numpy(b).to(dev) for b in (g, p, m, v)]


def _rel_ok(got, ref, tol=1e-6):
    return bool(((got.float() - ref.float()).abs()
                 <= tol * ref.float().abs() + 1e-30).all())


@pytest.mark.parametrize("model_dtype", [None, "float32", "bfloat16",
                                         "float16"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("n", [1 << 20, 1001, 3])
def test_adam_kernel_matches_plain(n, adam_w_mode, model_dtype, cuda_device):
    from apex_tpu_torch.multi_tensor_apply import kernels
    bufs = _update_buffers(n, cuda_device, seed=n)
    scal = torch.tensor([[1e-2, 0.9, 0.999, 1e-8, 0.01, 1 / (1 - 0.9 ** 3),
                          1 / (1 - 0.999 ** 3), 0.7 / 64]],
                        device=cuda_device)
    mdt = getattr(torch, model_dtype) if model_dtype else None
    before = build.LAUNCHES["adam"]
    got = kernels.fused_adam_flat(*bufs, scal, adam_w_mode=adam_w_mode,
                                  model_dtype=mdt)
    torch.cuda.synchronize()
    assert build.LAUNCHES["adam"] == before + 1
    ref = kernels.fused_adam_flat_reference(*bufs, scal,
                                            adam_w_mode=adam_w_mode,
                                            model_dtype=mdt)
    assert len(got) == len(ref)
    for name, a, r in zip(("p", "m", "v", "copy"), got, ref):
        assert a.dtype == r.dtype, name
        # the fp16 copy: one fp16 step of an update held to 1e-6
        tol = 1e-3 if name == "copy" and model_dtype == "float16" else 1e-6
        assert _rel_ok(a, r, tol), (name, float((a.float() - r.float())
                                                .abs().max()))


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("n", [1 << 20, 1001, 3])
def test_lamb_stage1_kernel_matches_plain(n, adam_w_mode, cuda_device):
    from apex_tpu_torch.multi_tensor_apply import kernels
    bufs = _update_buffers(n, cuda_device, seed=n + 1)
    scal = torch.tensor([[0.9, 0.999, 1e-6, 0.01, 1 / (1 - 0.9 ** 2),
                          1 / (1 - 0.999 ** 2), 0.35, 1 / 128, 0.1]],
                        device=cuda_device)
    before = build.LAUNCHES["lamb_stage1"]
    got = kernels.fused_lamb_stage1_flat(*bufs, scal,
                                         adam_w_mode=adam_w_mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lamb_stage1"] == before + 1
    ref = kernels.fused_lamb_stage1_flat_reference(*bufs, scal,
                                                   adam_w_mode=adam_w_mode)
    for name, a, r in zip(("u", "m", "v"), got, ref):
        assert _rel_ok(a, r), (name, float((a - r).abs().max()))


@pytest.fixture
def nccl_world1(tmp_path, cuda_device):
    """A world-1 NCCL default group (and its gloo twin) on the card."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import initialize_distributed
    initialize_distributed(init_file=str(tmp_path / "store"))
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def test_zero_lamb_step_repeats_bit_for_bit(nccl_world1, cuda_device):
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    rng = np.random.default_rng(3)
    shapes = {"a": (33, 7), "b": (4096,), "c": (3, 5, 11), "d": (257,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda_device) for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda_device) for k, s in shapes.items()}
    opt = DistributedFusedLAMB(lr=1e-2, impl="fused")
    state = opt.init(params)
    before = build.LAUNCHES["lamb_stage1"]
    (p1, s1), (p2, s2) = (opt.step(state, grads, params) for _ in range(2))
    torch.cuda.synchronize()
    assert build.LAUNCHES["lamb_stage1"] == before + 2
    assert torch.equal(s1.p, s2.p) and torch.equal(s1.gnorm, s2.gnorm)
    for k in shapes:
        assert torch.equal(p1[k], p2[k]), k
    assert int(s1.count) == 1


def test_cuda_tensor_on_gloo_group_raises(nccl_world1, cuda_device):
    from apex_tpu_torch.parallel import collectives
    x = torch.zeros(256, device=cuda_device)
    with pytest.raises(RuntimeError, match="NCCL"):
        collectives.reduce_scatter_flat(x, nccl_world1)
    with pytest.raises(RuntimeError, match="NCCL"):
        collectives.allgather_flat(x, nccl_world1)
    with pytest.raises(RuntimeError, match="gloo"):
        collectives.allgather_flat(x.cpu(), None)       # NCCL default group


# -- fused dense + activation ------------------------------------------------

DENSE_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 4e-3}


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
@pytest.mark.parametrize("activation,bias", [("relu", True),
                                             ("sigmoid", True),
                                             ("none", False)])
@pytest.mark.parametrize("m,k,n", [(1024, 1024, 512), (1000, 1000, 1000),
                                   (10, 24, 12), (9, 16, 8), (257, 33, 130),
                                   (1, 1, 1)])
def test_dense_act_kernel_matches_plain(m, k, n, activation, bias, dtype,
                                        cuda_device):
    from apex_tpu_torch.ops import fused_mlp
    rng = np.random.default_rng(m + k + n)
    tdt = getattr(torch, dtype)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda_device, tdt)

    x, w = t((m, k), 1.0), t((k, n), k ** -0.5)
    b = t((n,), 1.0) if bias else None
    before = build.LAUNCHES["dense_act"]
    out = fused_mlp.fused_dense_act(x, w, b, activation)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dense_act"] == before + 1
    ref = fused_mlp.fused_dense_act_reference(x, w, b, activation)
    assert out.dtype == tdt and out.shape == (m, n)
    assert _close(out, ref, DENSE_TOL[dtype]), float(
        (out.float() - ref.float()).abs().max())


def _dense_case(m, k, n, dtype, device, seed, x_offset=0):
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device, tdt)

    x = t((m * k + x_offset,), 1.0)[x_offset:].view(m, k)
    return x, t((k, n), k ** -0.5), t((n,), 1.0)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("m,k,n,activation", [
    (8192, 1024, 4096, "relu"), (8192, 4096, 4096, "relu"),
    (8192, 4096, 1024, "relu"),               # the MLP's three layers
    (8191, 1000, 1000, "sigmoid"),            # M, K, N off the tiles
    (1000, 1000, 136, "none"), (8191, 4096, 136, "relu"),
    (1, 1024, 4096, "relu")])
def test_dense_act_sm90_route_matches_plain(m, k, n, activation, dtype,
                                            cuda_device):
    """The TMA + wgmma kernel (the route ``_route`` names for these
    inputs) against the plain version, with and without a bias."""
    from apex_tpu_torch.ops import fused_mlp
    x, w, b = _dense_case(m, k, n, dtype, cuda_device, m + k + n)
    assert fused_mlp._route(x, w) == "sm90"
    for bias in (b, None):
        before = build.LAUNCHES["dense_act"]
        out = fused_mlp.fused_dense_act(x, w, bias, activation)
        torch.cuda.synchronize()
        assert build.LAUNCHES["dense_act"] == before + 1
        ref = fused_mlp.fused_dense_act_reference(x, w, bias, activation)
        assert out.dtype == x.dtype and out.shape == (m, n)
        assert _close(out, ref, DENSE_TOL[dtype]), float(
            (out.float() - ref.float()).abs().max())


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_dense_act_misaligned_x_takes_mma_route(dtype, cuda_device):
    from apex_tpu_torch.ops import fused_mlp
    x, w, b = _dense_case(1000, 1000, 1000, dtype, cuda_device, 3,
                          x_offset=1)
    assert x.is_contiguous() and fused_mlp._route(x, w) == "mma"
    out = fused_mlp.fused_dense_act(x, w, b, "relu")
    ref = fused_mlp.fused_dense_act_reference(x, w, b, "relu")
    assert _close(out, ref, DENSE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8192, 4096, 4096), (8191, 1000, 136)])
def test_dense_act_sm90_repeats_bit_for_bit(m, k, n, dtype, cuda_device):
    """Each output is one fp32 sum in a fixed order: a second call gives
    the same bits."""
    from apex_tpu_torch.ops import fused_mlp
    x, w, b = _dense_case(m, k, n, dtype, cuda_device, 7)
    assert fused_mlp._route(x, w) == "sm90"
    first = fused_mlp.fused_dense_act(x, w, b, "relu")
    assert torch.equal(fused_mlp.fused_dense_act(x, w, b, "relu"), first)


def test_dense_act_sm90_entry_refuses_what_tma_cannot_take(cuda_device):
    """The TMA route's C entry point refuses a K or N off the multiple of 8
    and a misaligned pointer with an error: it sends nothing to another
    kernel."""
    from apex_tpu_torch.ops import fused_mlp
    lib = build.library()
    x, w, b = _dense_case(64, 72, 64, "float16", cuda_device, 11)
    out = torch.empty(64, 64, dtype=x.dtype, device=cuda_device)
    s = build.stream_of(x)
    args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr()]
    assert lib.apex_dense_act_sm90(*args, 64, 64, 72, 1, 2, s) == 0
    torch.cuda.synchronize()
    assert _close(out, fused_mlp.fused_dense_act_reference(x, w, b), 4e-3)
    assert lib.apex_dense_act_sm90(*args, 64, 64, 71, 1, 2, s) != 0
    assert lib.apex_dense_act_sm90(*args, 64, 60, 72, 1, 2, s) != 0
    bad = list(args)
    bad[0] += 2
    assert lib.apex_dense_act_sm90(*bad, 63, 64, 72, 1, 2, s) != 0
    assert lib.apex_dense_act_sm90(*args, 64, 64, 72, 1, 0, s) != 0


def test_dense_act_backward_on_the_card(cuda_device):
    """Autograd through the kernel forward: the gradients of the plain
    forward's autograd, fp32."""
    from apex_tpu_torch.ops import fused_mlp
    rng = np.random.default_rng(1)
    ins = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        cuda_device).requires_grad_(True) for s in ((64, 48), (48, 40),
                                                    (40,))]
    fused_mlp.dense_act(*ins, "sigmoid").square().sum().backward()
    got = [a.grad.clone() for a in ins]
    for a in ins:
        a.grad = None
    fused_mlp.fused_dense_act_reference(*ins, "sigmoid").square().sum() \
        .backward()
    for g, a in zip(got, ins):
        assert _close(g, a.grad, 1e-4)


@pytest.mark.parametrize("low", ["float16", "bfloat16"])
def test_mlp_function_under_amp_casts_on_the_card(low, cuda_device):
    """fp32 x, w and b under amp O1 / O4 casts: ``mlp_function`` casts x
    alone, and each layer's mixed dtypes run the fp32 kernel on the
    widened inputs (one launch a layer), out in the low type, matching
    the plain version within the fused MLP's 16-bit limits (fp16 2e-3,
    bf16 2e-2: one rounding of each layer's fp32 output)."""
    from apex_tpu_torch.amp import amp as amp_mod
    from apex_tpu_torch.mlp import mlp_function
    from apex_tpu_torch.ops import fused_mlp
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device)
    x, ws, bs = t(32, 64), [t(64, 48), t(48, 16)], [t(48), t(16)]
    before = build.LAUNCHES["dense_act"]
    with amp_mod.autocast(getattr(torch, low)):
        out = mlp_function(x, ws, bs, "relu")
    torch.cuda.synchronize()
    assert build.LAUNCHES["dense_act"] == before + 2
    assert out.dtype == getattr(torch, low)
    h = x.to(getattr(torch, low))
    for w, b in zip(ws, bs):
        h = fused_mlp.fused_dense_act_reference(h, w, b, "relu")
    assert _close(out, h, {"float16": 2e-3, "bfloat16": 2e-2}[low])


# -- multi_tensor_scale / multi_tensor_axpby ----------------------------------

@pytest.mark.parametrize("scalar", ["number", "tensor"])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "float32"), ("float16", "float32"), ("float32", "float16"),
    ("bfloat16", "float32"), ("float32", "bfloat16"),
    ("float16", "float16")])
@pytest.mark.parametrize("n", [1 << 20, 1001, 3])
def test_scale_kernel_matches_plain(n, in_dtype, out_dtype, scalar,
                                    cuda_device):
    from apex_tpu_torch.multi_tensor_apply import kernels
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.standard_normal(n) * 100).astype(
        np.float32)).to(cuda_device, getattr(torch, in_dtype))
    s = 1.0 / 65536 if scalar == "number" else torch.tensor(
        1.0 / 3.0, device=cuda_device)
    odt = getattr(torch, out_dtype)
    before = build.LAUNCHES["mt_scale"]
    out, flag = kernels.multi_tensor_scale(x, s, odt)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mt_scale"] == before + 1
    ref, rflag = kernels.multi_tensor_scale_reference(x, s, odt)
    assert out.dtype == odt and torch.equal(out, ref)
    assert flag.is_cuda and int(flag) == int(rflag) == 0


@pytest.mark.parametrize("case", ["inf", "nan", "fp16_overflow", "tail_inf"])
@pytest.mark.parametrize("op", ["scale", "axpby"])
def test_overflow_flag_on_the_card(op, case, cuda_device):
    from apex_tpu_torch.multi_tensor_apply import kernels
    n = 4099
    x = torch.randn(n, device=cuda_device)
    out_dtype = None
    if case == "inf":
        x[17] = float("inf")
    elif case == "nan":
        x[2048] = float("nan")
    elif case == "tail_inf":
        x[n - 1] = float("-inf")
    else:
        x[300], out_dtype = 70000.0, torch.float16
    if op == "scale":
        out, flag = kernels.multi_tensor_scale(x, 1.0, out_dtype)
        ref, rflag = kernels.multi_tensor_scale_reference(x, 1.0, out_dtype)
    else:
        out, flag = kernels.multi_tensor_axpby(x, x, 1.0, 0.0, out_dtype)
        ref, rflag = kernels.multi_tensor_axpby_reference(x, x, 1.0, 0.0,
                                                          out_dtype)
    torch.cuda.synchronize()
    assert int(flag) == int(rflag) == 1
    assert torch.equal(torch.isfinite(out), torch.isfinite(ref))
    # a clean call after a flagged one starts from a zeroed flag
    _, clean = kernels.multi_tensor_scale(torch.ones(n, device=cuda_device),
                                          2.0)
    assert int(clean) == 0


@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "float32"), ("float16", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "float16")])
@pytest.mark.parametrize("n", [1 << 20, 1001, 3])
def test_axpby_kernel_matches_plain(n, in_dtype, out_dtype, cuda_device):
    from apex_tpu_torch.multi_tensor_apply import kernels
    rng = np.random.default_rng(n + 7)
    x, y = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda_device, getattr(torch, in_dtype)) for _ in range(2))
    a = torch.tensor(1.7, device=cuda_device)
    odt = getattr(torch, out_dtype)
    before = build.LAUNCHES["mt_axpby"]
    out, flag = kernels.multi_tensor_axpby(x, y, a, -0.3, odt)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mt_axpby"] == before + 1
    ref, rflag = kernels.multi_tensor_axpby_reference(x, y, a, -0.3, odt)
    assert out.dtype == odt and torch.equal(out, ref)
    assert int(flag) == int(rflag) == 0


def test_applier_on_the_card(cuda_device):
    from apex_tpu_torch.multi_tensor_apply import (kernels,
                                                   multi_tensor_applier)
    rng = np.random.default_rng(3)
    shapes = [(64, 32), (32,), (32, 8), (8,)]
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float16)).to(
        cuda_device) for s in shapes]
    ys = [torch.ones(s, device=cuda_device) for s in shapes]
    before = dict(build.LAUNCHES)
    (out, flag), fl = multi_tensor_applier(kernels.multi_tensor_axpby,
                                           [xs, ys], 2.0, -0.5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mt_axpby"] == before.get("mt_axpby", 0) + 1
    assert int(flag) == 0
    for x, back in zip(xs, fl.unflatten(out, dtype=torch.float32)):
        assert torch.equal(back, x.float() * 2.0 - 0.5)


# -- a dtype no kernel has a branch for (float64) is refused -----------------

def test_fp16_refused_on_the_card(cuda_device):
    """fp16 has a branch in every kernel now; float64 has none, and every
    wrapper refuses it before a launch."""
    from apex_tpu_torch.contrib.xentropy import softmax_xentropy as xent
    from apex_tpu_torch.multi_tensor_apply import kernels
    f64 = torch.float64
    x = torch.randn(8, 64, device=cuda_device)
    w64 = torch.ones(64, device=cuda_device, dtype=f64)
    q = torch.zeros(2, 8, 64, device=cuda_device, dtype=f64)
    calls = {
        "ln_fwd_x": lambda: port_ln.ln_fwd(x.double(), None, None, 1e-5),
        "ln_fwd_weight": lambda: port_ln.ln_fwd(x, w64, w64, 1e-5),
        "ln_bwd_weight": lambda: port_ln.ln_bwd(
            x, x, torch.zeros(8, 1, device=cuda_device),
            torch.ones(8, 1, device=cuda_device), w64),
        "l2norm": lambda: kernels.multi_tensor_l2norm(
            torch.zeros(256, device=cuda_device, dtype=f64)),
        "xent": lambda: xent._xent_fwd(
            x.double(), torch.zeros(8, dtype=torch.long, device=cuda_device),
            0.0),
        "flash": lambda: pflash._flash_fwd(
            q, q, q, torch.zeros(1, 1, 8, device=cuda_device), False, 0.0,
            0, 1),
        "adam_model_copy": lambda: kernels.fused_adam_flat(
            *(torch.zeros(256, device=cuda_device) for _ in range(4)),
            torch.zeros(1, 8, device=cuda_device), model_dtype=f64),
    }
    before = dict(build.LAUNCHES)
    for name, call in calls.items():
        with pytest.raises(TypeError):
            call()
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == before


MHA_MASKS = ["none", "key_pad", "time", "causal"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", MHA_MASKS)
@pytest.mark.parametrize("module", ["self", "encdec"])
def test_mha_fast_path_on_the_card_matches_plain(module, mask, dtype,
                                                 cuda_device):
    """Both attention modules' fast path on the card (flash forward and
    fused backward kernels, the layer-norm kernels with norm-add) against
    the same weights on the CPU, where every wrapper takes its plain
    version: output and every parameter's gradient, fp32 1e-4 on the peak
    rule; bf16 2e-2, the output on the peak rule and the gradients
    relative in norm (a weight's gradient sums rounded bf16 products of
    either sign, so its small elements carry the cancellation).  A
    non-causal time mask reaches the kernels as a (1, Sq, Sk) bias."""
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    E, H, B, SQ = 256, 4, 3, 48
    SK = SQ if module == "self" else 80
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(len(mask) + SK)
    xq = torch.from_numpy(rng.standard_normal((SQ, B, E)).astype(np.float32))
    xk = torch.from_numpy(rng.standard_normal((SK, B, E)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((SQ, B, E)).astype(np.float32))
    kw = {}
    if mask == "key_pad":
        m = torch.zeros(B, SK, dtype=torch.bool)
        for b in range(B):
            m[b, SK - 3 - 4 * b:] = True
        kw["key_padding_mask"] = m
    elif mask == "time":
        m = torch.from_numpy(rng.random((SQ, SK)) < 0.3)
        m[:, 0] = False
        kw["attn_mask"] = m
    elif mask == "causal":
        kw["attn_mask"] = torch.ones(SQ, SK, dtype=torch.bool).triu(1)
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        gen = torch.Generator().manual_seed(3)
        if module == "self":
            mod = SelfMultiheadAttn(E, H, dropout=0.1, bias=True,
                                    include_norm_add=True, generator=gen,
                                    device=dev)
            args = (xq.to(dev, tdt),)
        else:
            mod = EncdecMultiheadAttn(E, H, dropout=0.1,
                                      include_norm_add=True, generator=gen,
                                      device=dev)
            args = (xq.to(dev, tdt), xk.to(dev, tdt))
        before = dict(build.LAUNCHES)
        out, _ = mod(*args, is_training=True, dropout_rng=None,
                     **{k: v.to(dev) for k, v in kw.items()})
        (out.float() * cot.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in ("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd"):
                assert build.LAUNCHES[name] == before.get(name, 0) + 1, name
        results.append((out.detach().cpu(), {
            n: p.grad.cpu() for n, p in mod.named_parameters()}))
    (go, gg), (co, cg) = results
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert _peak_close(go, co, tol)
    for n in cg:
        if dtype == "float32":
            assert _peak_close(gg[n], cg[n], tol), (n, float(
                (gg[n] - cg[n]).abs().max()))
        else:   # bf16 sums cancel in the small elements: held in norm
            rel = float((gg[n] - cg[n]).norm() / cg[n].norm())
            assert rel <= tol, (n, rel)


def test_native_loader_hands_out_pinned_batches(cuda_device, tmp_path):
    """The native prefetch ring on the card's host: built
    (``native_available``), its batches pinned CPU tensors equal to the
    numpy copies of the same stream, and a ``non_blocking`` copy to the
    card carries the same values."""
    from apex_tpu_torch.data import ArraySource, NativeLoader, \
        native_available
    assert native_available()
    rng = np.random.default_rng(5)
    np.save(tmp_path / "x.npy", rng.standard_normal((10, 3, 4)).astype(
        np.float32))
    np.save(tmp_path / "y.npy", rng.integers(0, 9, 10).astype(np.int32))
    src = ArraySource(data=np.load(tmp_path / "x.npy", mmap_mode="r"),
                      labels=np.load(tmp_path / "y.npy", mmap_mode="r"))
    pinned = list(NativeLoader(src, batch_size=4, steps=3, seed=2))
    plain = list(NativeLoader(src, batch_size=4, steps=3, seed=2,
                              device_put=False))
    for (x, y), (nx, ny) in zip(pinned, plain):
        assert x.is_pinned() and y.is_pinned()
        assert np.array_equal(x.numpy(), nx) and np.array_equal(y.numpy(),
                                                                ny)
        xd = x.to(cuda_device, non_blocking=True)
        torch.cuda.synchronize()
        assert torch.equal(xd.cpu(), x)


def _o5_step_inputs(cuda_device, layers=2):
    """A small O5 BERT-shaped step on the card: (state, batch, cfg)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import TransformerConfig, transformer_init
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = TransformerConfig(vocab_size=512, max_len=128, num_layers=layers,
                            d_model=256, num_heads=4, d_ff=1024,
                            dtype=torch.bfloat16, attn_impl="fast",
                            remat=True)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=cuda_device)
    st = amp.initialize(params, FusedLAMB(lr=1e-3, impl="fused"),
                        opt_level="O5", verbosity=0)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, 512, (2, 128), generator=gen).to(
        cuda_device) for k in ("tokens", "targets")}
    return st, batch, cfg


def test_kernel_launches_reach_the_recording_from_the_backward(cuda_device):
    """``attrib.op_table`` over an O5 step on the card: every hand-kernel
    launch is one ``other`` row, the backward's (flash_bwd, ln_bwd, run
    on autograd's device thread) included, as many as ``LAUNCHES``
    counts."""
    from apex_tpu_torch.telemetry import attrib
    from apex_tpu_torch.train import train_step
    st, batch, cfg = _o5_step_inputs(cuda_device)
    train_step(st, batch, cfg)
    build.LAUNCHES.clear()
    table = attrib.op_table(train_step, st, batch, cfg)
    rows = {}
    for r in table["rows"]:
        if r["class"] == "other" and r["opcode"] in build.KERNEL_FUNCTIONS:
            rows[r["opcode"]] = rows.get(r["opcode"], 0) + 1
            assert r["flops"] == 0.0 and r["bytes"] > 0
    assert rows == dict(build.LAUNCHES)
    assert rows["flash_bwd"] == 2 and rows["ln_bwd"] == 6
    assert rows["flash_fwd"] == 4 and rows["ln_fwd"] == 10


def test_o5_step_makes_no_host_sync(cuda_device):
    """One O5 step (FusedLAMB fused, flash, remat) under
    ``set_sync_debug_mode("error")``: no op of the step waits on the
    card (the learning rate is filled on the device, not copied)."""
    from apex_tpu_torch.train import train_step
    st, batch, cfg = _o5_step_inputs(cuda_device)
    st, _ = train_step(st, batch, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, loss = train_step(st, batch, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(loss))


# -- the hooked bucketed backward (overlap="bucketed") ---------------------------

def _hooked_step_inputs(cuda_device):
    from apex_tpu_torch.models import TransformerConfig, transformer_init
    cfg = TransformerConfig(vocab_size=512, max_len=128, num_layers=4,
                            d_model=256, num_heads=4, d_ff=1024,
                            attn_impl="fast", remat=True)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=cuda_device)
    toks = torch.randint(0, 512, (4, 128),
                         generator=torch.Generator().manual_seed(1)).to(
                             cuda_device)
    return cfg, params, {"tokens": toks, "targets": toks}


def _hooked_grad(ddp, cfg, params, batch):
    from apex_tpu_torch.models import transformer_loss
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    leaves, td = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(td, leaves)
    return ddp.grad(transformer_loss(tree, batch, cfg), tree)


def test_hooked_bucketed_backward_makes_no_host_sync(nccl_world1,
                                                     cuda_device):
    """The hooked backward's copies into the buckets, their asynchronous
    NCCL all-reduces and the waits run under
    ``set_sync_debug_mode("error")``; the result is the deferred path's
    bits."""
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.utils.pytree import tree_leaves
    cfg, params, batch = _hooked_step_inputs(cuda_device)
    ddp = DistributedDataParallel(overlap="bucketed", message_size=200_000)
    _hooked_grad(ddp, cfg, params, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _hooked_grad(ddp, cfg, params, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = _hooked_grad(DistributedDataParallel(overlap="off"), cfg, params,
                       batch)
    assert ddp.last_reduction is not None
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(ref)))


def test_hooked_bucket_zero_launches_before_the_last_hook(nccl_world1,
                                                          cuda_device):
    """Bucket 0 (the last layers' largest leaves, reverse flat order) is
    enqueued while the backward still runs: before the last gradient hook
    fires; buckets launch in the layout's order, each after its leaves."""
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.overlap import partition_buckets
    cfg, params, batch = _hooked_step_inputs(cuda_device)
    ddp = DistributedDataParallel(overlap="bucketed", message_size=200_000)
    _hooked_grad(ddp, cfg, params, batch)
    torch.cuda.synchronize()
    eng = ddp.last_reduction
    layout = partition_buckets(params, message_size=200_000)
    assert [list(b.leaf_ids) for b in eng.buckets] == \
        [list(b.leaf_ids) for b in layout.buckets]
    assert len(eng.buckets) > 1
    assert eng.launch_log == list(range(len(eng.buckets)))
    last_hook = max(i for i, (kind, _) in enumerate(eng.events)
                    if kind == "hook")
    assert eng.events.index(("launch", 0)) < last_hook
    seen = set()
    for kind, i in eng.events:
        if kind == "hook":
            seen.add(i)
        else:
            assert set(layout.buckets[i].leaf_ids) <= seen


# -- the parallel engines' card paths ------------------------------------------

def test_ulysses_flash_is_the_flash_kernels_bits(nccl_world1, cuda_device):
    """At world 1 the Ulysses exchanges are copies: ``ulysses_flash_
    attention`` gives the direct flash call's bits in out, dq, dk and dv,
    one forward and one backward launch a call."""
    from apex_tpu_torch.parallel import ulysses_flash_attention
    gen = torch.Generator().manual_seed(0)
    B, H, S, D = 1, 4, 512, 64
    q, k, v, cot = (torch.randn(B, H, S, D, generator=gen).to(
        cuda_device, torch.bfloat16) for _ in range(4))

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qq, kk, vv)
        grads = torch.autograd.grad((out.float() * cot.float()).sum(),
                                    (qq, kk, vv))
        return (out.detach(),) + grads

    def direct(qq, kk, vv):
        bias = torch.zeros((1, 1, S), dtype=torch.float32,
                           device=cuda_device)
        return pflash.flash_attention(
            (qq * D ** -0.5).reshape(B * H, S, D), kk.reshape(B * H, S, D),
            vv.reshape(B * H, S, D), bias, causal=True,
            heads=H).reshape(B, H, S, D)

    before = dict(build.LAUNCHES)
    got = run(lambda qq, kk, vv: ulysses_flash_attention(
        qq, kk, vv, axis_name=None, causal=True))     # the default group
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd"):
        assert build.LAUNCHES[name] == before.get(name, 0) + 1, name
    ref = run(direct)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_sequence_ops_refuse_cuda_tensors_on_gloo(nccl_world1, cuda_device):
    """A CUDA tensor on a gloo group raises before any exchange."""
    from apex_tpu_torch.parallel import ring_attention, ulysses_attention
    q = torch.ones(1, 2, 8, 4, device=cuda_device)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(RuntimeError, match="NCCL only"):
            fn(q, q, q, axis_name=nccl_world1)


def test_moe_fast_step_launches(cuda_device):
    """The MoE model with ``attn_impl="fast"``: a forward and backward
    launches #1 and #4 once a layer, #5 and #6 twice a layer plus the
    head's, #7 once."""
    from apex_tpu_torch.models import (MoETransformerConfig,
                                       moe_transformer_init,
                                       moe_transformer_loss)
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    cfg = MoETransformerConfig(vocab_size=1024, max_len=128, num_layers=2,
                               d_model=256, num_heads=4, d_ff=512,
                               attn_impl="fast")
    params = moe_transformer_init(cfg, torch.Generator().manual_seed(0),
                                  device=cuda_device)
    leaves, td = tree_flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    toks = torch.randint(0, 1024, (2, 128),
                         generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    before = dict(build.LAUNCHES)
    loss = moe_transformer_loss(tree_unflatten(td, leaves),
                                {"tokens": toks, "targets": toks}, cfg)
    torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    want = {"flash_fwd": 2, "flash_bwd": 2, "ln_fwd": 5, "ln_bwd": 5,
            "xent_fwd": 1}
    got = {k: build.LAUNCHES[k] - before.get(k, 0) for k in build.LAUNCHES
           if build.LAUNCHES[k] != before.get(k, 0)}
    assert got == want
    assert torch.isfinite(loss)


def test_reduction_releases_its_buffers(nccl_world1, cuda_device):
    """A DDP reduction on the card leaves nothing allocated once its
    input and output trees are dropped, the cyclic collector off."""
    import gc
    from apex_tpu_torch.parallel import DistributedDataParallel
    was = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        grads = {"a": torch.ones(2 ** 22, device=cuda_device),
                 "b": torch.ones(2 ** 22, device=cuda_device)}
        red = DistributedDataParallel().allreduce_grads(grads)
        del grads, red
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base
    finally:
        if was:
            gc.enable()


def test_elastic_8_to_1_resume_of_a_tiny_zero1_step_is_bitwise(
        nccl_world1, cuda_device, tmp_path):
    """The zero1 + int8 error-feedback flagship step (a tiny config) under
    the guard on a world-1 NCCL group: its step-4 checkpoint, re-chunked
    in numpy into a world-8 manifest, resumes through ``elastic.install``
    and ends on the uninterrupted run's bits."""
    import apex_tpu_torch.elastic as elastic
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.resilience import (CheckpointManager, GuardConfig,
                                           TrainGuard, faults, guard)
    from apex_tpu_torch.train import flagship_guard_step
    cfg = TransformerConfig(vocab_size=64, max_len=20, num_layers=1,
                            d_model=32, num_heads=2, d_ff=64,
                            attn_impl="fast")
    gen = torch.Generator().manual_seed(7)
    toks = [torch.randint(0, 64, (8, 20), generator=gen).to(cuda_device)
            for _ in range(8)]

    def run(d, plan=None):
        state, step, layout, shards = flagship_guard_step(
            cfg, ddp_kwargs={"collective_scheme":
                             "int8_blockscale:min_bytes=0"},
            device=cuda_device)
        g = TrainGuard(step, GuardConfig(
            ckpt_dir=str(d), save_every_steps=2, check_every=2,
            enabled=True, world_size=1, ckpt_meta={"layout": layout}),
            plan=plan, state_shards=shards,
            shard_group=step.weight_update.group)
        state, rep = g.run(state, lambda i: toks[i], 8)
        return state, rep, step, shards, layout

    ref, _, step, shards, layout1 = run(tmp_path / "clean")
    _, rep, _, _, _ = run(tmp_path / "pre", faults.parse("preempt@5"))
    assert rep.status == "preempted"
    payload = checkpoint.load(CheckpointManager(str(tmp_path / "pre"))
                              .path_for(4))
    lay8 = step.weight_update.layout_meta(ref[0], 8)
    used, tot = lay8["used"], lay8["flat_total"]
    leaves = []
    for h, kind in zip(payload["leaves"], guard._leaf_kinds(ref, shards)):
        if kind in ("shard", "stack"):
            v = np.zeros((tot,), h.dtype)
            v[:used] = h[:used]
            h = np.stack([v] + [np.zeros_like(v)] * 7) if kind == "stack" \
                else v
        leaves.append(h)
    CheckpointManager(str(tmp_path / "w8"), meta={
        "world_size": 8, "layout": lay8}).save(4, {"step": 4,
                                                   "leaves": leaves})
    elastic.install()
    try:
        got, rep, _, _, _ = run(tmp_path / "w8")
    finally:
        elastic.uninstall()
    assert rep.resharded_from == 8 and rep.resumed_from == 4
    for a, b in zip(guard._leaves(got), guard._leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_enabled_controller_adds_no_host_sync(cuda_device, tmp_path):
    """A guarded run on the card with an enabled controller, a tracer (the
    goodput signals live) and a straggler on a stamped world of 8: every
    controller call (the per-step feed and the window) runs under
    ``set_sync_debug_mode("error")``, the guard's reads stay its checks
    plus its snapshots, and the quarantine acts."""
    from apex_tpu_torch.control import ControlConfig, RunController
    from apex_tpu_torch.resilience import GuardConfig, TrainGuard, faults
    from apex_tpu_torch.telemetry import trace
    ctl = RunController(ControlConfig(enabled=True, max_actions=2))
    for name in ("on_window", "feed_device_stats"):
        real = getattr(ctl, name)

        def strict(*a, _real=real, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        setattr(ctl, name, strict)
    w0 = torch.zeros(1 << 16, device=cuda_device)

    def step(w, b):
        return w - 0.1 * (w - b), ((w - b) ** 2).mean()
    batches = [torch.full_like(w0, float(i)) for i in range(12)]
    g = TrainGuard(step, GuardConfig(
        ckpt_dir=str(tmp_path), save_every_steps=4, check_every=2,
        enabled=True, world_size=8), controller=ctl,
        plan=faults.parse("straggler@2x40:4.0"))
    prev = trace.set_tracer(trace.Tracer(enabled=True,
                                         flight_dir=str(tmp_path)))
    try:
        _, rep = g.run(w0, lambda i: batches[i], 12)
    finally:
        trace.set_tracer(prev)
    assert rep.status == "preempted" and rep.resize_to == 7
    assert g.host_reads == g.health_checks + rep.checkpoints
    assert ctl.windows >= 3 and ctl.actions_fired == 1
