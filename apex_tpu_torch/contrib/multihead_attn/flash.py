"""Flash-attention forward: the hand-written Hopper kernel and its plain
version.

Counterpart of the forward half of
``apex_tpu/contrib/multihead_attn/flash.py``: :func:`flash_attention` and
:func:`_flash_fwd` keep its contract.  q (BH, Sq, D) is pre-scaled, k/v are
(BH, Sk, D), the additive fp32 bias is (1|B, 1|Sq, Sk) with its batch row
taken as ``bh // heads``; ``causal`` masks col > row to -1e30; dropout acts
on the probabilities after the softmax denominator, with the counter-hash
mask :func:`_dropout_keep`; a row that saw only masked keys (max <= -5e29)
is dead and emits zeros with lse = +1e30.

The kernel is ``apex_tpu_torch/csrc/flash_fwd.cu``.  :func:`_flash_fwd`
launches it for CUDA tensors and takes :func:`_reference` only for CPU
tensors.  Only the forward is ported: a CUDA input that requires a gradient
raises, since the backward kernels come with the training slice.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ...utils import build

__all__ = ["flash_attention", "_flash_fwd", "_reference", "_dropout_keep",
           "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1e30
#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128)

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """``a * c mod 2**32`` for ``a`` (int64 tensor or int) in [0, 2**32):
    split ``c`` in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _u32(x):
    """``x`` as uint32 bits: an int stays a host int (no device copy), a
    tensor becomes int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _dropout_keep(seed, bh, row0, col0, shape, rate,
                  device=None) -> torch.Tensor:
    """Keep-mask (float32, ``shape`` broadcast against ``bh``) over global
    (head, row, col) coordinates: the squirrel3-style uint32 hash of the
    TPU kernel, bit for bit, computed in int64 masked to 32 bits."""
    if device is None:
        device = bh.device if isinstance(bh, torch.Tensor) else "cpu"
    rows = _u32(row0) + torch.arange(shape[0], device=device)[:, None]
    cols = _u32(col0) + torch.arange(shape[1], device=device)[None, :]
    x = (_mul32(rows & _M32, 0x9E3779B1) + _mul32(cols & _M32, 0x85EBCA77)
         + _mul32(_u32(seed), 0xC2B2AE3D)) & _M32
    x = _mul32(x, 0xB5297A4D)
    x = x ^ _mul32(_u32(bh), 0x27D4EB2F)
    x = x ^ (x >> 8)
    x = (x + 0x68E31DA4) & _M32
    x = x ^ ((x << 8) & _M32)
    x = _mul32(x, 0x1B56C4E9)
    x = x ^ (x >> 8)
    return (x >= int(rate * (2 ** 32))).to(torch.float32)


def _check_layout(q, k, v, bias, heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bh % heads:
        raise ValueError(f"leading dim {bh} is not a multiple of heads="
                         f"{heads} — pass heads explicitly")
    if bias.dim() != 3 or bias.shape[2] != k.shape[1] \
            or bias.shape[1] not in (1, sq):
        raise ValueError(f"bias must be (1|B, 1|Sq, Sk), got "
                         f"{tuple(bias.shape)}")
    if bias.shape[0] not in (1, bh // heads):
        # bias rows are indexed by bh // heads (batch): a per-batch mask
        # with the default heads=1 would silently read the wrong rows
        raise ValueError(
            f"bias batch dim {bias.shape[0]} matches neither 1 nor "
            f"batch={bh // heads} (= leading dim {bh} / heads={heads}); "
            f"pass the heads= the q layout uses")


def _reference(q, k, v, bias, causal, dropout_rate, seed, heads
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out (BH, Sq, D), lse (BH, Sq, 1)
    f32).  Mirrors the TPU package's ``_xla_reference`` (softmax over keys,
    then dropout with the same hash mask, dead rows -> 0) and adds the lse."""
    _check_layout(q, k, v, bias, heads)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    b = bias.float()
    if b.shape[0] != 1:
        b = b.repeat_interleave(heads, dim=0)      # (B, ., Sk) -> (BH, ., Sk)
    s = s + b
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    dead = m <= NEG_INF / 2
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    p = p / safe_l[..., None]
    if dropout_rate > 0.0:
        heads_idx = torch.arange(bh, device=q.device)[:, None, None]
        keep = _dropout_keep(seed, heads_idx, 0, 0, (sq, sk), dropout_rate)
        p = p * keep / (1.0 - dropout_rate)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = torch.where(dead[..., None], torch.zeros_like(o), o).to(q.dtype)
    lse = torch.where(dead, torch.full_like(m, -NEG_INF), m + torch.log(safe_l))
    return o, lse[..., None]


def _check_cuda_inputs(q, k, v, bias, dropout_rate):
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"flash bias must be float32, got {bias.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head dims {HEAD_DIMS}, got "
                         f"{q.shape[2]}")
    if q.shape[0] > 65535:
        raise ValueError(f"flash kernel takes at most 65535 batch-heads, got "
                         f"{q.shape[0]}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention on CUDA is forward-only: the backward kernels "
            "come with the training slice (see ROADMAP.md)")


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, causal: bool, dropout_rate: float,
               seed: Union[int, torch.Tensor], heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Sq, D), k/v (BH, Sk, D), bias (1|B, 1|Sq, Sk) f32.
    Returns out (BH, Sq, D), lse (BH, Sq, 1) f32."""
    if not q.is_cuda:
        return _reference(q, k, v, bias, causal, dropout_rate, seed, heads)
    _check_layout(q, k, v, bias, heads)
    _check_cuda_inputs(q, k, v, bias, dropout_rate)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    threshold = int(dropout_rate * (2 ** 32)) if dropout_rate > 0.0 else 0
    seed32 = ((int(seed) + 2 ** 31) % 2 ** 32) - 2 ** 31   # as int32 bits
    err = build.library().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1], d, heads,
        bias.shape[0], bias.shape[1], int(bool(causal)), threshold,
        float(1.0 - dropout_rate), seed32, build.dtype_code(q.dtype),
        build.stream_of(q))
    build.check(err, "flash_fwd")
    build.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention(q, k, v, bias, seed=0, causal=False, dropout_rate=0.0,
                    heads=1) -> torch.Tensor:
    """Fused attention.  q (BH, Sq, D) pre-scaled; k/v (BH, Sk, D); bias
    (1|B, 1|Sq, Sk) additive f32 (zeros for none).  Returns (BH, Sq, D)."""
    out, _ = _flash_fwd(q, k, v, bias, causal, dropout_rate, seed, heads)
    return out
