"""Sequence (context) parallelism: ring attention and Ulysses.

Counterpart of ``apex_tpu/parallel/sequence.py``.  Each rank of the
``seq`` group holds a contiguous block of the sequence (rank ``i`` the
positions ``[i * S_local, (i + 1) * S_local)``); q, k and v are (B, H,
S_local, D).  ``axis_name`` is a mesh axis name (resolved through the
ambient mesh, :func:`~apex_tpu_torch.parallel.mesh.use_mesh`) or a process
group.

- :func:`ring_attention`: the k/v blocks rotate around the ring (n
  rotations, the last returning each block to its origin, as the JAX
  package's loop carries it) while each rank folds every block into a
  running online softmax, so no (S, S) matrix of the whole sequence ever
  exists.
- :func:`ulysses_attention`: an ``all_to_all`` re-shards sequence ->
  heads, each rank runs full-sequence attention on its head group, and the
  inverse ``all_to_all`` re-shards back; needs ``H % n == 0``.
- :func:`ulysses_flash_attention`: Ulysses with the flash kernels on the
  gathered-sequence leg (``backward`` picks their gradient route).

The collectives are ``torch.autograd.Function``\\ s whose backward is the
transposed collective (:mod:`.comm`); autograd differentiates the rest.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import comm
from .mesh import SEQ_AXIS, group_rank, group_size, resolve_group

__all__ = ["SequenceShardingError", "validate_sp", "ring_attention",
           "ulysses_attention", "ulysses_flash_attention"]

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


class SequenceShardingError(ValueError):
    """A sequence-parallel structural constraint is violated (heads vs
    the Ulysses all-to-all, sequence length vs the ring chunking).
    Raised eagerly with the offending numbers in the message."""


def validate_sp(seq: int, heads: int, sp: int, strategy: str) -> None:
    """``seq`` must chunk evenly over ``sp`` ranks (both ring and Ulysses
    shard the sequence), and Ulysses re-shards heads, so ``heads`` must
    divide over ``sp``.  Raises :class:`SequenceShardingError` naming the
    numbers."""
    if sp <= 1:
        return
    if seq % sp:
        raise SequenceShardingError(
            f"sequence length {seq} does not chunk over sp={sp} devices "
            f"({seq} % {sp} != 0) — ring/Ulysses sequence parallelism "
            "needs equal per-device sequence blocks")
    if strategy == "ulysses" and heads % sp:
        raise SequenceShardingError(
            f"num_heads {heads} does not divide over sp={sp} devices "
            f"({heads} % {sp} != 0) — the Ulysses all-to-all re-shards "
            "sequence -> heads; use ring attention or an sp that divides "
            "the head count")


def _block_attn(q, k, v, *, causal, q_off, k_off, m, l, acc):
    """Fold one k/v block into the running online softmax.
    q (B, H, Sq, D); k/v (B, H, Sk, D); m/l (B, H, Sq); acc (B, H, Sq, D)
    fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        qpos = q_off + torch.arange(Sq, device=q.device)[:, None]
        kpos = k_off + torch.arange(Sk, device=q.device)[None, :]
        s = torch.where((kpos <= qpos)[None, None], s,
                        torch.full((), _NEG, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with every key masked keep m at its (finite) init
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(s <= _NEG * 0.5, torch.zeros((), device=p.device),
                        p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   v.float())
    return m_new, l_new, acc_new


def ring_attention(q, k, v, *, axis_name=SEQ_AXIS, causal: bool = False,
                   scale: Optional[float] = None):
    """Ring self/cross attention over a sequence-sharded group.  q/k/v
    (B, H, S_local, D), this rank's contiguous blocks (k/v may have their
    own local length); returns (B, H, S_local, D)."""
    group = resolve_group(axis_name)
    n, idx = group_size(group), group_rank(group)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    m = torch.full((B, H, Sq), _NEG * 0.5, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for i in range(n):
        src = (idx - i) % n                  # origin of the block held
        m, l, acc = _block_attn(q, kk, vv, causal=causal, q_off=idx * Sq,
                                k_off=src * Sk, m=m, l=l, acc=acc)
        # rotate after folding; the n-th rotation returns the blocks home
        kk = comm.rotate(kk, group, 1)
        vv = comm.rotate(vv, group, 1)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q, k, v, *, axis_name=SEQ_AXIS, causal: bool = False,
                      scale: Optional[float] = None, attn_fn=None):
    """Ulysses all-to-all context parallelism: q/k/v (B, H, S_local, D)
    sequence-sharded -> (B, H/n, S_full, D) head-sharded, full attention
    (``attn_fn(q_scaled, k, v, causal=)`` when given, e.g. the flash
    kernels), and back.  Requires ``H % n == 0``."""
    group = resolve_group(axis_name)
    n = group_size(group)
    B, H, S_local, D = q.shape
    if H % n:
        raise SequenceShardingError(
            f"num_heads {H} does not divide over seq axis size {n} "
            f"({H} % {n} != 0) — the Ulysses all-to-all re-shards "
            "sequence -> heads; use ring attention or a head count the "
            "axis divides")
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    def to_heads(x):
        return comm.all_to_all(x, group, 1, 2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if attn_fn is not None:
        out = attn_fn(qh * scale, kh, vh, causal=causal)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", qh.float() * scale, kh.float())
        if causal:
            S = s.shape[-1]
            keep = torch.ones((S, S), dtype=torch.bool,
                              device=s.device).tril()
            s = torch.where(keep[None, None], s,
                            torch.full((), _NEG, device=s.device))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    return comm.all_to_all(out.to(q.dtype), group, 2, 1)


def ulysses_flash_attention(q, k, v, *, axis_name=SEQ_AXIS,
                            causal: bool = False,
                            scale: Optional[float] = None,
                            backward: str = "auto"):
    """Ulysses with the flash kernels on the gathered-sequence leg: after
    the all_to_all each rank holds its head group at full sequence length,
    the layout the kernels take.  ``backward`` routes the flash core's
    gradient (``"pallas"`` / ``"xla"`` / ``"auto"``, see
    :func:`~apex_tpu_torch.contrib.multihead_attn.flash.flash_attention`);
    the all_to_alls differentiate the same either way."""
    from ..contrib.multihead_attn.flash import flash_attention

    def attn_fn(qh, kh, vh, causal):
        B, Hl, S, D = qh.shape
        Sk = kh.shape[2]         # cross-attention: kv length may differ
        bias = torch.zeros((1, 1, Sk), dtype=torch.float32,
                           device=qh.device)
        out = flash_attention(qh.reshape(B * Hl, S, D).contiguous(),
                              kh.reshape(B * Hl, Sk, D).contiguous(),
                              vh.reshape(B * Hl, Sk, D).contiguous(), bias,
                              causal=causal, heads=Hl, backward=backward)
        return out.reshape(B, Hl, S, D)
    return ulysses_attention(q, k, v, axis_name=axis_name, causal=causal,
                             scale=scale, attn_fn=attn_fn)
