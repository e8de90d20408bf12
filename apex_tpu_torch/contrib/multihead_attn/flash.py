"""Flash attention: the hand-written Hopper kernels and their plain
versions.

Counterpart of ``apex_tpu/contrib/multihead_attn/flash.py``:
:func:`flash_attention`, :func:`_flash_fwd` and :func:`_flash_bwd` keep its
contract.  q (BH, Sq, D) is pre-scaled, k/v are (BH, Sk, D), the additive
fp32 bias is (1|B, 1|Sq, Sk) with its batch row taken as ``bh // heads``;
``causal`` masks col > row to -1e30; dropout acts on the probabilities
after the softmax denominator, with the counter-hash mask
:func:`_dropout_keep`; a row that saw only masked keys (max <= -5e29) is
dead and emits zeros with lse = +1e30.  q, k and v are fp32, bf16 or
fp16 (all three of one type), as the JAX kernels take any float type: out,
dq, dk and dv come in q's type, lse and the dq partials in fp32, and P and
dS are rounded to the input type before their products, in the kernels as
in the plain versions.

The backward rebuilds P from two fp32 residuals a row that the forward
keeps apart, the row max m and log l (the log of the softmax
denominator), as exp((s - m) - log l) (:func:`_recompute`): the public
lse = m + log l cannot carry log l where m is a large finite mask (at m =
-1e9 fp32's step is 64), and P rebuilt from it would be l times too large
on a row whose every visible key carries such a mask.  The forward's
:func:`_flash_fwd_res` returns them as one (BH, Sq, 2) ``stats`` tensor
beside out and lse (a dead row: m = +1e30, log l = 0, so P = 0); each
backward takes it where it takes ``lse``, and a public (BH, Sq, 1) lse
given there instead reads as m = lse, log l = 0 (:func:`_stats_of`), the
rebuild of the JAX package's kernels.

The kernels are ``apex_tpu_torch/csrc/flash_fwd.cu`` (forward) and
``flash_bwd.cu``: the fused recompute backward (dq as per-k-tile fp32
partials summed here) and the split route's two kernels, dq alone and
dk/dv alone, which :func:`_flash_bwd` takes when the dq partials would
pass :data:`_FUSE_BUFFER_CAP_MB` (long sequences).  fp16 / bf16 run on
``wgmma``; fp32 at D <= 128 runs the forward, the fused backward and the
dk/dv kernel on the tensor cores in 3xTF32 (three TF32 products a pair of
split operands, fp32's accuracy), the split dq and D = 256 on scalar FMA.
:func:`_flash_fwd`,
:func:`_flash_bwd_fused`, :func:`_flash_bwd_dq` and :func:`_flash_bwd_dkv`
launch them for CUDA tensors and take their plain versions
(:func:`_reference`, :func:`_flash_bwd_reference`,
:func:`_flash_bwd_dq_reference`, :func:`_flash_bwd_dkv_reference`) only
for CPU tensors.  :func:`_head_dim_plan` picks the kernel for a head dim:
the instances built for 32, 64, 128 and 256 (:data:`HEAD_DIMS`; D = 256
on the scalar-FMA kernels in every dtype), or past 256 the column-chunked
scalar kernels, which take any multiple of :data:`CHUNK_D` (one CTA per
tile and 128-column output chunk, q k^T summed over all of D in 128-wide
pieces).  A CUDA call at another D pads q, k, v (and dO) with zero columns
up to the plan's D (:func:`_pad_head_dim`) and slices out, dq, dk and dv
back, which is exact (zero columns add nothing to q k^T and give zero
output columns, and the dropout hash reads no D).  No head dim lacks a
kernel; only a grid of more than 2**31 - 1 CTAs (tiles x chunks x BH, far
past the card's memory) is refused by the launch.  ``backward="xla"`` takes autograd of the plain
:func:`_reference` instead, by the caller's choice; ``"pallas"`` (the JAX
package's name for its kernel route, kept so the amp option keeps its
meaning) and ``"auto"`` take the kernels.

Knobs, each in the JAX package's order (explicit argument > environment >
the amp default where there is one > tuning profile, read on the card only
through :func:`~apex_tpu_torch.utils.tuning.get_on_gpu` > built-in): the
backward route (:func:`_resolve_backward`: ``APEX_TPU_FLASH_BWD_IMPL``,
``flash_bwd_impl``) and the fused-or-split choice (:func:`_resolve_fuse`:
``APEX_TPU_FLASH_BWD_FUSE``, ``flash_bwd_fuse``, then the cap
``APEX_TPU_FLASH_BWD_FUSE_MB``).  The JAX block keys and pins
(``flash_block_q/k``, ``flash_bwd_{,dq_,dkv_}block_q/k``,
``APEX_TPU_FLASH_BLOCK_Q/_K``, ``APEX_TPU_FLASH_BWD_*_BLOCK_*``,
``APEX_TPU_FLASH_VMEM_MB``) size Pallas blocks against VMEM; the CUDA
kernels' tiles are fixed when they are compiled (``kPartKeys``,
:data:`BWD_K_TILE`), so the port reads none of them and a profile or an
environment that holds them changes no route and no launch.

Its callers: the attention modules' ``impl="fast"``
(:mod:`~apex_tpu_torch.contrib.multihead_attn.modules`:
``SelfMultiheadAttn``, ``EncdecMultiheadAttn``) and the transformer's
``attn_impl="fast"`` (:mod:`apex_tpu_torch.models.transformer`).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from ...utils import build, tuning

__all__ = ["flash_attention", "_flash_fwd", "_flash_bwd", "_flash_bwd_fused",
           "_flash_bwd_dq", "_flash_bwd_dkv", "_flash_bwd_reference",
           "_flash_bwd_dq_reference", "_flash_bwd_dkv_reference",
           "_reference", "_dropout_keep", "_resolve_backward",
           "_resolve_fuse", "set_default_backward", "BACKWARD_IMPLS",
           "_kernel_head_dim", "_head_dim_plan", "HeadDimPlan",
           "_pad_head_dim", "_flash_fwd_res",
           "_stats_of",
           "NEG_INF", "HEAD_DIMS", "CHUNK_D", "BWD_K_TILE"]

NEG_INF = -1e30
#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 128, 256)
#: output columns a CTA of the D > 256 kernels owns (``kChunk`` in
#: ``flash_fwd.cu`` / ``flash_bwd.cu``): D past 256 pads to a multiple of it
CHUNK_D = 128
#: keys per CTA of the fused and dk/dv kernels (``kPartKeys`` in
#: ``flash_bwd.cu``), the JAX package's default backward ``bk``: the dq
#: partials are (BH, ceil(Sk / BWD_K_TILE), Sq, D) fp32
BWD_K_TILE = 128
#: fused-backward dq-partials buffer cap in MB (the JAX package's rule):
#: past it the split kernels run
_FUSE_BUFFER_CAP_MB = 1024.0

BACKWARD_IMPLS = ("auto", "pallas", "xla")
# process-level default for backward="auto", set by amp.initialize
_DEFAULT_BACKWARD = "auto"


def set_default_backward(value: str) -> None:
    """Set the process-level default consulted by ``backward="auto"``."""
    global _DEFAULT_BACKWARD
    if value not in BACKWARD_IMPLS:
        raise ValueError(f"backward must be one of {BACKWARD_IMPLS}, "
                         f"got {value!r}")
    _DEFAULT_BACKWARD = value


def _resolve_backward(backward: str) -> str:
    """Explicit "pallas"/"xla" argument > ``APEX_TPU_FLASH_BWD_IMPL`` > the
    amp default (:func:`set_default_backward`) > the tuning profile's
    ``flash_bwd_impl`` (on the card only) > "pallas", the kernels."""
    if backward not in BACKWARD_IMPLS:
        raise ValueError(f"backward must be one of {BACKWARD_IMPLS}, "
                         f"got {backward!r}")
    if backward != "auto":
        return backward
    env = os.environ.get("APEX_TPU_FLASH_BWD_IMPL")
    if env in ("pallas", "xla"):
        return env
    if _DEFAULT_BACKWARD != "auto":
        return _DEFAULT_BACKWARD
    prof = tuning.get_on_gpu("flash_bwd_impl", None)
    if prof in ("pallas", "xla"):
        return prof
    return "pallas"


def _resolve_fuse(fuse, BH, Sq, Sk, D) -> bool:
    """Fused-vs-split strategy: an explicit ``fuse`` >
    ``APEX_TPU_FLASH_BWD_FUSE`` (``0`` / ``off`` / ``false`` / ``no`` /
    empty split, anything else fuses) > the tuning profile's
    ``flash_bwd_fuse`` (on the card only) > fuse while the
    (BH, ceil(Sk/BWD_K_TILE), Sq, D) fp32 dq-partials buffer stays under
    the cap, :data:`_FUSE_BUFFER_CAP_MB` or ``APEX_TPU_FLASH_BWD_FUSE_MB``.

    The JAX package's rule counts the partials with its resolved backward
    ``bk``, the port with its fixed 128-key tiles, so the two built-in
    decisions agree where the JAX ``bk`` resolves to 128 (its default):
    at BH 128 x 2048 x 2048 x 64 both fuse (exactly 1 GiB of partials), at
    BH 64 x 4096 x 4096 x 64 both split."""
    if fuse is not None:
        return bool(fuse)
    env = os.environ.get("APEX_TPU_FLASH_BWD_FUSE")
    if env is not None:
        return env.lower() not in ("0", "off", "false", "no", "")
    prof = tuning.get_on_gpu("flash_bwd_fuse", None)
    if prof is not None:
        return bool(prof)
    cap = float(os.environ.get("APEX_TPU_FLASH_BWD_FUSE_MB",
                               _FUSE_BUFFER_CAP_MB)) * 2 ** 20
    nk = -(-Sk // BWD_K_TILE)
    return BH * nk * Sq * D * 4 <= cap

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
    return _reference_res(q, k, v, bias, causal, dropout_rate, seed,
                          heads)[:2]


def _reference_res(q, k, v, bias, causal, dropout_rate, seed, heads):
    """:func:`_reference` and the backward's residual: (out, lse, stats
    (BH, Sq, 2) f32 = (m, log l), a dead row (+1e30, 0))."""
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
    log_l = torch.log(safe_l)
    lse = torch.where(dead, torch.full_like(m, -NEG_INF), m + log_l)
    stats = torch.stack((torch.where(dead, torch.full_like(m, -NEG_INF), m),
                         torch.where(dead, torch.zeros_like(m), log_l)), -1)
    return o, lse[..., None], stats


class HeadDimPlan(NamedTuple):
    """The kernel a head dim takes: the padded head dim ``d`` it runs at,
    and its ``route``, ``"instance"`` (one of :data:`HEAD_DIMS`) or
    ``"chunked"`` (the column-chunked scalar kernels, D > 256)."""
    d: int
    route: str


def _head_dim_plan(d: int) -> HeadDimPlan:
    """The least of :data:`HEAD_DIMS` at or above ``d``, else (D > 256) the
    chunked kernels at ``d`` rounded up to a multiple of :data:`CHUNK_D`."""
    if d < 1:
        raise ValueError(f"head dim must be positive, got {d}")
    for hd in HEAD_DIMS:
        if d <= hd:
            return HeadDimPlan(hd, "instance")
    return HeadDimPlan(-(-d // CHUNK_D) * CHUNK_D, "chunked")


def _kernel_head_dim(d: int) -> int:
    """The head dim the kernel that takes ``d`` runs at
    (:func:`_head_dim_plan`)."""
    return _head_dim_plan(d).d


def _pad_head_dim(tensors, d_to: int):
    """Each (BH, S, D) tensor of ``tensors`` with zero columns appended up
    to ``d_to``.  Zero columns of q and k add nothing to q k^T, zero
    columns of v give zero columns of out, dO's meet v's zeros in dO v^T,
    and the dropout hash reads (bh, row, col, seed), not D: a kernel's
    results on the padded inputs, sliced back to D, are its results at D."""
    return tuple(t if t.shape[-1] == d_to
                 else F.pad(t, (0, d_to - t.shape[-1])) for t in tensors)


def _unpad(t, d: int):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_cuda_inputs(q, k, v, bias, dropout_rate):
    build.dtype_code(q.dtype, "the flash kernels")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"flash bias must be float32, got {bias.dtype}")
    if _kernel_head_dim(q.shape[2]) != q.shape[2]:
        raise ValueError(f"flash kernel runs at head dims {HEAD_DIMS} and "
                         f"multiples of {CHUNK_D} past them, got "
                         f"{q.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")


def _launch_args(q, k, bias, causal, dropout_rate, seed, heads):
    """The scalar arguments both kernels take after their pointers."""
    threshold = int(dropout_rate * (2 ** 32)) if dropout_rate > 0.0 else 0
    seed32 = ((int(seed) + 2 ** 31) % 2 ** 32) - 2 ** 31   # as int32 bits
    bh, sq, d = q.shape
    return (bh, sq, k.shape[1], d, heads, bias.shape[0], bias.shape[1],
            int(bool(causal)), threshold, float(1.0 - dropout_rate), seed32,
            build.dtype_code(q.dtype, "the flash kernels"),
            build.stream_of(q))


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, causal: bool, dropout_rate: float,
               seed: Union[int, torch.Tensor], heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Sq, D), k/v (BH, Sk, D), bias (1|B, 1|Sq, Sk) f32.
    Returns out (BH, Sq, D), lse (BH, Sq, 1) f32."""
    return _flash_fwd_res(q, k, v, bias, causal, dropout_rate, seed,
                          heads)[:2]


def _flash_fwd_res(q, k, v, bias, causal, dropout_rate, seed, heads
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_flash_fwd` and the backward's residual: (out, lse, stats
    (BH, Sq, 2) f32 = (row max m, log l)), from one launch."""
    if not q.is_cuda:
        return _reference_res(q, k, v, bias, causal, dropout_rate, seed,
                              heads)
    _check_layout(q, k, v, bias, heads)
    d = q.shape[2]
    q, k, v = _pad_head_dim((q, k, v), _kernel_head_dim(d))
    _check_cuda_inputs(q, k, v, bias, dropout_rate)
    bh, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    stats = torch.empty((bh, sq, 2), dtype=torch.float32, device=q.device)
    err = build.library().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), stats.data_ptr(),
        *_launch_args(q, k, bias, causal, dropout_rate, seed, heads))
    build.check(err, "flash_fwd")
    build.launched("flash_fwd", q, k, v, bias, out, lse, stats)
    return _unpad(out, d), lse, stats


def _stats_of(lse: torch.Tensor) -> torch.Tensor:
    """The backward's (BH, Sq, 2) f32 residual (m, log l): ``lse`` itself
    when it is one (the forward's ``stats``), else a public (BH, Sq, 1) lse
    read as m = lse, log l = 0."""
    if lse.shape[-1] == 2:
        return lse
    lse = lse.float()
    return torch.cat((lse, torch.zeros_like(lse)), -1)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _recompute(q, k, v, bias, causal, dropout_rate, seed, heads, lse, delta,
               do):
    """The backward's recompute over whole rows (the TPU package's
    ``_recompute_p`` and the kernels' shared prologue): (P, the dropout
    factor keep / (1 - rate) or None, dS = P * (dP * keep - delta)), fp32
    (BH, Sq, Sk).  P = exp((s - m) - log l) from ``lse`` read through
    :func:`_stats_of`."""
    _check_layout(q, k, v, bias, heads)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    b = bias.float()
    if b.shape[0] != 1:
        b = b.repeat_interleave(heads, dim=0)
    s = s + b
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    stats = _stats_of(lse).float()
    p = torch.exp((s - stats[..., :1]) - stats[..., 1:])
    del s
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    keep = None
    if dropout_rate > 0.0:
        heads_idx = torch.arange(bh, device=q.device)[:, None, None]
        keep = _dropout_keep(seed, heads_idx, 0, 0, (sq, sk), dropout_rate) \
            / (1.0 - dropout_rate)
        dp = dp * keep
    return p, keep, p * (dp - delta.float())


def _dq_from(ds, k, q_dtype):
    return torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(),
                        k.float()).to(q_dtype)


def _dkv_from(p, keep, ds, q, k, v, do):
    pd = p if keep is None else p * keep
    dv = torch.einsum("bqk,bqd->bkd", pd.to(do.dtype).float(), do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_reference(q, k, v, bias, causal, dropout_rate, seed, heads,
                         lse, delta, do
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: the recompute formula
    of the TPU package's ``_recompute_p`` and ``_bwd_fused_kernel`` over
    whole rows, with the kernel's roundings (Pd and dS cast to the input
    dtype before their products).  Not autograd of :func:`_reference`."""
    p, keep, ds = _recompute(q, k, v, bias, causal, dropout_rate, seed,
                             heads, lse, delta, do)
    return (_dq_from(ds, k, q.dtype),) + _dkv_from(p, keep, ds, q, k, v, do)


def _flash_bwd_dq_reference(q, k, v, bias, causal, dropout_rate, seed,
                            heads, lse, delta, do) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: the dq part of
    :func:`_flash_bwd_reference`."""
    _, _, ds = _recompute(q, k, v, bias, causal, dropout_rate, seed, heads,
                          lse, delta, do)
    return _dq_from(ds, k, q.dtype)


def _flash_bwd_dkv_reference(q, k, v, bias, causal, dropout_rate, seed,
                             heads, lse, delta, do
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: the dk, dv part of
    :func:`_flash_bwd_reference`."""
    p, keep, ds = _recompute(q, k, v, bias, causal, dropout_rate, seed,
                             heads, lse, delta, do)
    return _dkv_from(p, keep, ds, q, k, v, do)


def _flash_bwd_fused(q, k, v, bias, causal, dropout_rate, seed, heads, lse,
                     delta, do
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from one kernel: dk and dv directly, dq as per-k-tile
    fp32 partials (BH, nk, Sq, D) summed here.  ``lse`` is the forward's
    (BH, Sq, 2) stats or a (BH, Sq, 1) lse (:func:`_stats_of`), delta (BH,
    Sq, 1) f32; ``do`` is (BH, Sq, D) in q's dtype."""
    if not q.is_cuda:
        return _flash_bwd_reference(q, k, v, bias, causal, dropout_rate, seed,
                                    heads, lse, delta, do)
    d = q.shape[2]
    q, k, v, do = _pad_bwd(q, k, v, bias, heads, do)
    lse = _stats_of(lse).contiguous()
    _check_bwd_inputs(q, k, v, bias, dropout_rate, heads, lse, delta, do)
    bh, sq, dp = q.shape
    nk = -(-k.shape[1] // BWD_K_TILE)
    dq_part = torch.empty((bh, nk, sq, dp), dtype=torch.float32,
                          device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = build.library().apex_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_part.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        *_launch_args(q, k, bias, causal, dropout_rate, seed, heads))
    build.check(err, "flash_bwd")
    build.launched("flash_bwd", q, k, v, bias, do, lse, delta, dq_part,
                   dk, dv)
    return (_unpad(dq_part.sum(dim=1).to(q.dtype), d), _unpad(dk, d),
            _unpad(dv, d))


def _pad_bwd(q, k, v, bias, heads, do):
    """q, k, v and dO padded to the kernel's head dim (the layout checked
    first, so a bad shape is named as such)."""
    _check_layout(q, k, v, bias, heads)
    return _pad_head_dim((q, k, v, do), _kernel_head_dim(q.shape[2]))


def _check_bwd_inputs(q, k, v, bias, dropout_rate, heads, lse, delta, do):
    """The checks every backward kernel's wrapper applies before a
    launch."""
    _check_layout(q, k, v, bias, heads)
    _check_cuda_inputs(q, k, v, bias, dropout_rate)
    bh, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash backward needs a contiguous, 16-byte "
                             f"aligned {name} on {q.device}")
    if lse.dtype != torch.float32 or lse.numel() != 2 * bh * sq:
        raise ValueError("stats must be float32 (BH, Sq, 2)")
    if delta.dtype != torch.float32 or delta.numel() != bh * sq:
        raise ValueError("delta must be float32 (BH, Sq, 1)")


def _flash_bwd_dq(q, k, v, bias, causal, dropout_rate, seed, heads, lse,
                  delta, do) -> torch.Tensor:
    """dq alone, from the split route's dq kernel (one CTA per 64- or
    128-query tile accumulating over the k tiles): (BH, Sq, D) in q's
    dtype."""
    if not q.is_cuda:
        return _flash_bwd_dq_reference(q, k, v, bias, causal, dropout_rate,
                                       seed, heads, lse, delta, do)
    d = q.shape[2]
    q, k, v, do = _pad_bwd(q, k, v, bias, heads, do)
    lse = _stats_of(lse).contiguous()
    _check_bwd_inputs(q, k, v, bias, dropout_rate, heads, lse, delta, do)
    dq = torch.empty_like(q)
    err = build.library().apex_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_launch_args(q, k, bias, causal, dropout_rate, seed, heads))
    build.check(err, "flash_bwd_dq")
    build.launched("flash_bwd_dq", q, k, v, bias, do, lse, delta, dq)
    return _unpad(dq, d)


def _flash_bwd_dkv(q, k, v, bias, causal, dropout_rate, seed, heads, lse,
                   delta, do) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv, from the split route's dk/dv kernel (the fused kernel
    without its dq partials): each (BH, Sk, D) in k's dtype."""
    if not q.is_cuda:
        return _flash_bwd_dkv_reference(q, k, v, bias, causal, dropout_rate,
                                        seed, heads, lse, delta, do)
    d = q.shape[2]
    q, k, v, do = _pad_bwd(q, k, v, bias, heads, do)
    lse = _stats_of(lse).contiguous()
    _check_bwd_inputs(q, k, v, bias, dropout_rate, heads, lse, delta, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = build.library().apex_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        *_launch_args(q, k, bias, causal, dropout_rate, seed, heads))
    build.check(err, "flash_bwd_dkv")
    build.launched("flash_bwd_dkv", q, k, v, bias, do, lse, delta, dk,
                   dv)
    return _unpad(dk, d), _unpad(dv, d)


def _flash_bwd(q, k, v, bias, causal, dropout_rate, seed, heads, out, lse,
               do, fuse=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute-backward dispatcher: (dq, dk, dv).  delta = rowsum(dO * O)
    is computed once here, as on the TPU, and feeds whichever route
    :func:`_resolve_fuse` picks: the fused kernel, or the split dq and
    dk/dv kernels."""
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    if _resolve_fuse(fuse, q.shape[0], q.shape[1], k.shape[1], q.shape[2]):
        return _flash_bwd_fused(q, k, v, bias, causal, dropout_rate, seed,
                                heads, lse, delta, do)
    dq = _flash_bwd_dq(q, k, v, bias, causal, dropout_rate, seed, heads, lse,
                       delta, do)
    dk, dv = _flash_bwd_dkv(q, k, v, bias, causal, dropout_rate, seed, heads,
                            lse, delta, do)
    return dq, dk, dv


def _xla_bwd(q, k, v, bias, causal, dropout_rate, seed, heads, do):
    """(dq, dk, dv) by autograd of :func:`_reference`: the route a caller
    picks with ``backward="xla"``."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out, _ = _reference(*qkv, bias, causal, dropout_rate, seed, heads)
        return torch.autograd.grad(out, qkv, do)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, causal, dropout_rate, heads,
                backward):
        out, _, stats = _flash_fwd_res(q, k, v, bias, causal, dropout_rate,
                                       seed, heads)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        ctx.args = (seed, causal, dropout_rate, heads, backward)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, stats = ctx.saved_tensors
        seed, causal, dropout_rate, heads, backward = ctx.args
        do = do.contiguous()
        if _resolve_backward(backward) == "xla":
            dq, dk, dv = _xla_bwd(q, k, v, bias, causal, dropout_rate, seed,
                                  heads, do)
        else:
            dq, dk, dv = _flash_bwd(q, k, v, bias, causal, dropout_rate,
                                    seed, heads, out, stats, do)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, bias, seed=0, causal=False, dropout_rate=0.0,
                    heads=1, backward="auto") -> torch.Tensor:
    """Fused attention.  q (BH, Sq, D) pre-scaled; k/v (BH, Sk, D); bias
    (1|B, 1|Sq, Sk) additive f32 (zeros for none).  Returns (BH, Sq, D).

    Differentiable in q, k and v.  ``backward`` picks the gradient route:
    ``"pallas"`` / ``"auto"`` the backward kernel, ``"xla"`` autograd of the
    plain :func:`_reference`.  ``bias`` gets no gradient: it models masks,
    data rather than parameters, as in the JAX package."""
    _resolve_backward(backward)          # a bad value raises at the call
    return _FlashAttention.apply(q, k, v, bias, seed, causal, dropout_rate,
                                 heads, backward)
