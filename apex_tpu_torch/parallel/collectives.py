"""Collective-scheme registry: compressed and adaptive gradient reductions.

Counterpart of ``apex_tpu/parallel/collectives.py``, whole.  The JAX
package's mesh axis is a ``torch.distributed`` process group here (``None``:
the default group); everything else keeps the JAX names and semantics.

Built-in schemes
----------------
``fp32``
    Sum in fp32 (the reference's ``allreduce_always_fp32`` as a named
    scheme).  4 B an element on the wire.
``bf16``
    Sum in bf16: half the wire at bf16 precision.  2 B an element.
``int8_blockscale``
    Block-scaled int8 (EQuARX, arXiv:2506.17615): every ``block`` elements
    ship as int8 codes plus one fp32 scale (max-abs / 127); every rank's
    codes are gathered, dequantized and summed in fp32 on arrival.  ~1.03 B
    an element at the default block of 128.  An optional error-feedback
    residual folds each step's quantization error into the next step's
    gradient.
``adasum``
    Adaptive pairwise merge (arXiv:2006.02924) over a log2(world) tree:
    between the sum (orthogonal gradients) and the mean (parallel ones).
    4 B an element; it sets its own magnitude (``self_scaling``).

Selection: explicit argument > the live override (:func:`set_live_spec`) >
``APEX_TPU_COLLECTIVES`` > the tuning profile's ``ddp_collective_scheme``
with ``collective_min_compress_bytes`` (on the card only; the ZeRO paths
opt out with ``tuning_key=None``) > off (the plain reduction in the
gradients' dtype).  The spec grammar is
``"int8_blockscale:block=128,min_bytes=4096"``; leaves under ``min_bytes``
(fp32 bytes) stay ``fp32``.

Lowering: ``all_reduce`` (fp32, bf16), ``all_gather_into_tensor`` of the
(int8 codes, fp32 scales) pair or of the fp32 leaves (int8, adasum),
``all_to_all_single`` for the compressed reduce-scatter, the summing
reduce-scatter for the fp32 one.  A CUDA tensor goes over NCCL only
(:func:`~apex_tpu_torch.parallel.mesh.check_group_device`); nothing here
copies device data through the host.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so the codes and scales are the JAX codec's bits.

Chaos coverage: every compressed reduction passes :func:`chaos_gate`, the
``collective_fail`` schedule of the active fault plan
(:mod:`apex_tpu_torch.resilience.faults`), counted per entry point.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import check_group_device, group_size
from ..utils import tuning
from ..utils.pytree import tree_map

__all__ = ["DEFAULT_BLOCK", "DEFAULT_MIN_BYTES", "ENV_KNOB",
           "CollectiveError", "CollectiveSpec", "SchemeInfo",
           "register_scheme", "get_scheme", "available", "set_live_spec",
           "get_live_spec", "parse_spec", "resolve", "leaf_scheme",
           "wire_bytes", "init_residuals", "chaos_gate",
           "quantize_blockscale", "dequantize_blockscale", "adasum_pair",
           "adasum_merge", "reduce_scatter_flat", "allgather_flat",
           "rechunk_flat", "reduce", "launch_reduce", "axis_label", "dtype_name"]

#: one fp32 scale per 128 elements; divides every 128-lane ZeRO shard
DEFAULT_BLOCK = 128
#: leaves smaller than this (fp32 bytes) stay on the fp32 scheme
DEFAULT_MIN_BYTES = 4096
_SCALE_BYTES = 4

ENV_KNOB = "APEX_TPU_COLLECTIVES"
_ENV_OFF = ("", "0", "off", "none")

# PyTorch renamed the flat collectives (the old names warn in newer
# releases); the same arguments either way
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class CollectiveError(ValueError):
    """Unknown scheme name or unparseable spec string."""


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """A resolved scheme choice: the scheme, its quantization block and the
    byte threshold below which leaves stay fp32."""
    scheme: str = "fp32"
    block: int = DEFAULT_BLOCK
    min_bytes: int = DEFAULT_MIN_BYTES


@dataclasses.dataclass(frozen=True)
class SchemeInfo:
    """Registry entry.  ``reduce(x, group, block, residual)`` takes a
    pre-scaled fp32 tensor and returns ``(sum_over_group, new_residual)``
    (``new_residual`` None unless ``stateful`` and a residual was passed).
    ``self_scaling`` schemes (adasum) set their own magnitude.
    ``wire_bytes(n, block)`` is what a rank ships for ``n`` elements.
    ``launch`` (optional, same arguments) starts the reduction without
    waiting and returns ``(finish, new_residual)``, ``finish()`` giving the
    sum; a scheme without one reduces at its launch (:func:`launch_reduce`).
    """
    name: str
    reduce: Callable
    wire_bytes: Callable[[int, int], int]
    wire_dtype: str = "float32"
    stateful: bool = False
    self_scaling: bool = False
    launch: Optional[Callable] = None


_REGISTRY: Dict[str, SchemeInfo] = {}


def register_scheme(info: SchemeInfo) -> SchemeInfo:
    """Add (or replace) a scheme: custom schemes take the same per-leaf
    routing, metering and chaos gate as the built-ins."""
    _REGISTRY[info.name] = info
    return info


def get_scheme(name: str) -> SchemeInfo:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise CollectiveError(
            f"unknown collective scheme {name!r}; registered: "
            f"{available()}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# spec parsing and resolution
# ---------------------------------------------------------------------------

_OPT = re.compile(r"^(block|min_bytes)=(\d+)$")

# the run controller's actuation surface: a process-wide spec that resolve()
# takes for scheme=None ahead of the environment; an explicit scheme wins
_LIVE_SPEC: Optional[CollectiveSpec] = None


def set_live_spec(spec) -> Optional[CollectiveSpec]:
    """Install ``spec`` (a :class:`CollectiveSpec`, a spec string, a scheme
    name, or None to clear) as the live override; returns the previous
    one."""
    global _LIVE_SPEC
    prev = _LIVE_SPEC
    if spec is None:
        _LIVE_SPEC = None
    elif isinstance(spec, CollectiveSpec):
        get_scheme(spec.scheme)
        _LIVE_SPEC = spec
    else:
        _LIVE_SPEC = parse_spec(str(spec))
    return prev


def get_live_spec() -> Optional[CollectiveSpec]:
    return _LIVE_SPEC


def parse_spec(text: str) -> CollectiveSpec:
    """``"int8_blockscale:block=128,min_bytes=4096"`` -> a spec (options
    optional, in any order)."""
    head, _, opts = text.strip().partition(":")
    name = head.strip()
    if name not in _REGISTRY:
        raise CollectiveError(
            f"unknown collective scheme {name!r} in spec {text!r}; "
            f"registered: {available()}")
    kw = {}
    for raw in filter(None, (o.strip() for o in opts.split(","))):
        m = _OPT.match(raw)
        if not m:
            raise CollectiveError(
                f"bad option {raw!r} in collective spec {text!r}; "
                "expected block=N or min_bytes=N")
        kw[m.group(1)] = int(m.group(2))
    return CollectiveSpec(scheme=name, **kw)


def resolve(scheme=None, *, min_bytes: Optional[int] = None,
            block: Optional[int] = None,
            tuning_key: Optional[str] = "ddp_collective_scheme"
            ) -> Optional[CollectiveSpec]:
    """A scheme choice -> a spec, or None (the plain reduction).

    Precedence: explicit ``scheme`` (name, spec string or
    :class:`CollectiveSpec`) > the live override > ``APEX_TPU_COLLECTIVES``
    > the tuning profile's scheme under ``tuning_key`` with its
    ``collective_min_compress_bytes`` (on the card only; ``tuning_key=
    None`` opts out) > None.  ``min_bytes`` / ``block`` override the
    spec's own values."""
    spec: Optional[CollectiveSpec] = None
    if scheme is None:
        if _LIVE_SPEC is not None:
            spec = _LIVE_SPEC
            if min_bytes is not None:
                spec = dataclasses.replace(spec, min_bytes=int(min_bytes))
            if block is not None:
                spec = dataclasses.replace(spec, block=int(block))
            return spec
        env = os.environ.get(ENV_KNOB)
        if env is not None and env.strip().lower() in _ENV_OFF:
            return None
        if env:
            spec = parse_spec(env)
        elif tuning_key is not None:
            name = tuning.get_on_gpu(tuning_key)
            if name:
                spec = CollectiveSpec(
                    scheme=name,
                    min_bytes=tuning.get_on_gpu(
                        "collective_min_compress_bytes", DEFAULT_MIN_BYTES))
    elif isinstance(scheme, CollectiveSpec):
        spec = scheme
    else:
        spec = parse_spec(str(scheme))
    if spec is None:
        return None
    if min_bytes is not None:
        spec = dataclasses.replace(spec, min_bytes=int(min_bytes))
    if block is not None:
        spec = dataclasses.replace(spec, block=int(block))
    get_scheme(spec.scheme)
    return spec


def leaf_scheme(spec: CollectiveSpec, leaf_bytes: int) -> str:
    """The spec's scheme, or ``fp32`` for a leaf under the threshold."""
    if spec.scheme != "fp32" and leaf_bytes < spec.min_bytes:
        return "fp32"
    return spec.scheme


def wire_bytes(scheme: str, nelems: int, block: int = DEFAULT_BLOCK) -> int:
    """Bytes a rank ships for an ``nelems`` leaf under ``scheme``."""
    return get_scheme(scheme).wire_bytes(int(nelems), int(block))


def init_residuals(grads):
    """Zero error-feedback residuals shaped like ``grads`` (fp32, on each
    leaf's device)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def axis_label(group) -> str:
    """The name a meter records for ``group``: ``"data"`` (the JAX
    package's data axis) for the default group, else the group's global
    ranks."""
    if group is None or group is dist.group.WORLD:
        return "data"
    return "ranks" + ",".join(str(r) for r in
                              dist.get_process_group_ranks(group))


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the JAX package's spelling."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# the chaos gate
# ---------------------------------------------------------------------------

def chaos_gate(label: str) -> None:
    """Raise :class:`~apex_tpu_torch.resilience.faults.CollectiveFault`
    when a ``collective_fail`` fault is scheduled at this entry point's
    call index.  The index per label lives on the plan (cleared by
    ``FaultPlan.reset``), so it starts at 0 for every installed plan."""
    from ..resilience import faults as _faults
    plan = _faults.active_plan()
    if plan is None:
        return
    counters = getattr(plan, "_scheme_calls", None)
    if counters is None:
        counters = {}
        plan._scheme_calls = counters
    i = counters.get(label, 0)
    counters[label] = i + 1
    if plan.fire("collective_fail", i) is not None:
        raise _faults.CollectiveFault(
            f"injected collective failure in {label} (call {i})")


# ---------------------------------------------------------------------------
# the codec and the adaptive merge
# ---------------------------------------------------------------------------

def quantize_blockscale(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """1-D fp32 ``x`` -> ``(q, scales)``: int8 codes ``(nblocks, block)``
    (zero-padded to a whole block) and one fp32 max-abs / 127 scale a
    block.  An all-zero block gets scale 0 and dequantizes to zeros."""
    n = x.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xb = x.reshape(nb, block)
    amax = xb.abs().amax(dim=1)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, one ulp off max / 127 (the codec's bits need the
    # division itself)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe[:, None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_blockscale(q: torch.Tensor, scales: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Inverse of :func:`quantize_blockscale`: 1-D fp32 of length ``n``."""
    x = q.to(torch.float32) * scales[:, None]
    return x.reshape(-1)[:n]


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Adasum merge (arXiv:2006.02924 eq. 2): each side scaled down by
    its projection onto the other; a zero-norm side adds plainly."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    dot = torch.dot(fa, fb)
    na = torch.dot(fa, fa)
    nb = torch.dot(fb, fb)
    one = torch.ones_like(dot)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * na), one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), one)
    return ca * a + cb * b


def adasum_merge(stacked: torch.Tensor) -> torch.Tensor:
    """Pairwise-tree Adasum over the leading axis of ``stacked`` (``(world,
    ...)``); an odd element carries to the next round.  The tree is the
    same on every rank, so the result is too."""
    vals = [stacked[i] for i in range(stacked.shape[0])]
    while len(vals) > 1:
        nxt = [adasum_pair(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' ``x`` concatenated along dim 0, (world * d0, ...)."""
    out, work = _gather_async(x, group)
    work.wait()
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r receives the r-th equal slice of every rank's 1-D ``x``,
    in rank order."""
    check_group_device(x, group)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# built-in scheme reductions (x arrives fp32, pre-scaled by the caller).
# Each is a launch: it starts its collectives with ``async_op=True`` and
# returns ``(finish, new_residual)``, where ``finish()`` waits on them and
# gives the sum.  The blocking ``reduce`` is the launch finished at once, so
# the deferred and the backward-overlapped paths share one lowering.
# ---------------------------------------------------------------------------

def _gather_async(x: torch.Tensor, group):
    """Start the all-gather of :func:`_gather`: ``(out, work)``."""
    check_group_device(x, group)
    world = group_size(group)
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return out, _ALL_GATHER(out, x.contiguous(), group=group, async_op=True)


def _sum_launch(wire_dtype):
    def launch(x, group, block, residual):
        out = x.to(wire_dtype, copy=True)
        check_group_device(out, group)
        work = dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group,
                               async_op=True)

        def finish():
            work.wait()
            return out.to(torch.float32)
        return finish, None
    return launch


def _int8_launch(x, group, block, residual):
    """Quantize (the residual folded in), gather every rank's (codes,
    scales); ``finish`` dequantizes and sums in fp32."""
    flat = x.reshape(-1).to(torch.float32)
    if residual is not None:
        flat = flat + residual.reshape(-1)
    q, scales = quantize_blockscale(flat, block)
    new_res = None
    if residual is not None:
        new_res = (flat - dequantize_blockscale(q, scales, flat.shape[0])
                   ).reshape(x.shape)
    world = group_size(group)
    nb = q.shape[0]
    qg, wq = _gather_async(q, group)
    sg, ws = _gather_async(scales, group)

    def finish():
        wq.wait()
        ws.wait()
        total = (qg.view(world, nb, block).to(torch.float32)
                 * sg.view(world, nb)[..., None]).sum(dim=0)
        return total.reshape(-1)[:x.numel()].reshape(x.shape)
    return finish, new_res


def _adasum_launch(x, group, block, residual):
    world = group_size(group)
    stacked, work = _gather_async(x.reshape(1, -1).to(torch.float32), group)

    def finish():
        work.wait()
        return adasum_merge(stacked.view(world, -1)).reshape(x.shape)
    return finish, None


def _blocking(launch):
    """The scheme's ``reduce``: its launch, finished at once."""
    def reduce(x, group, block, residual):
        finish, new_res = launch(x, group, block, residual)
        return finish(), new_res
    return reduce


def _int8_wire(n, block):
    nb = -(-n // block)
    return nb * block + nb * _SCALE_BYTES


def _builtin(name, launch, wire_bytes, **kw):
    register_scheme(SchemeInfo(name=name, reduce=_blocking(launch),
                               launch=launch, wire_bytes=wire_bytes, **kw))


_builtin("fp32", _sum_launch(torch.float32), lambda n, b: 4 * n)
_builtin("bf16", _sum_launch(torch.bfloat16), lambda n, b: 2 * n,
         wire_dtype="bfloat16")
_builtin("int8_blockscale", _int8_launch, _int8_wire, wire_dtype="int8",
         stateful=True)
_builtin("adasum", _adasum_launch, lambda n, b: 4 * n, self_scaling=True)


# ---------------------------------------------------------------------------
# flat-buffer collectives of the sharded optimizer paths: ZeRO
# (contrib.optimizers.distributed_fused) and weight-update sharding
# (parallel.weight_update)
# ---------------------------------------------------------------------------

def _check_flat(x: torch.Tensor, group, what: str) -> int:
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 1-D buffer, got "
                         f"{tuple(x.shape)}")
    check_group_device(x, group)
    return group_size(group)


def reduce_scatter_flat(x: torch.Tensor, group=None,
                        spec: Optional[CollectiveSpec] = None, *,
                        residual: Optional[torch.Tensor] = None,
                        label: str = "reduce_scatter"):
    """Sum-reduce-scatter a 1-D buffer over ``group``: every rank gives its
    full buffer and receives its contiguous 1/world slice of the sum.

    ``spec`` None or ``fp32``: the summing reduce-scatter (no chaos gate,
    as the uncompressed DDP reduction).  Compressed schemes ship their
    wire form through ``all_to_all_single`` and sum locally, gated by
    :func:`chaos_gate` under ``"<label>.<scheme>"``; ``residual`` is the
    int8 error-feedback state (full flat fp32).  The caller owns the
    scaling and the metering.  Returns ``(shard, new_residual)``."""
    world = _check_flat(x, group, "reduce_scatter_flat")
    if x.numel() % world:
        raise ValueError(f"buffer of {x.numel()} does not split over "
                         f"{world} ranks")
    per = x.numel() // world
    if spec is None or spec.scheme == "fp32":
        shard = torch.empty(per, dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(shard, x, op=dist.ReduceOp.SUM, group=group)
        return shard, residual
    info = get_scheme(spec.scheme)
    chaos_gate(f"{label}.{info.name}")
    new_residual = residual
    if spec.scheme == "int8_blockscale":
        block = spec.block
        if per % block:
            raise ValueError(
                f"int8_blockscale reduce-scatter needs block ({block}) to "
                f"divide the shard length ({per}); use a block that "
                f"divides total/{world}")
        if residual is not None:
            x = x + residual
        q, scales = quantize_blockscale(x, block)
        if residual is not None:
            new_residual = x - dequantize_blockscale(q, scales, x.shape[0])
        nb_per = per // block
        qt = _all_to_all(q.reshape(-1), group).view(world, nb_per, block)
        st = _all_to_all(scales, group).view(world, nb_per)
        shard = (qt.to(torch.float32) * st[..., None]).sum(dim=0).reshape(
            per)
    elif spec.scheme == "bf16":
        xt = _all_to_all(x.to(torch.bfloat16), group).view(world, per)
        shard = xt.to(torch.float32).sum(dim=0)
    elif spec.scheme == "adasum":
        xt = _all_to_all(x.to(torch.float32), group).view(world, per)
        shard = adasum_merge(xt)
    else:
        raise ValueError(
            f"collective scheme {spec.scheme!r} has no reduce-scatter "
            "lowering (custom schemes ride the DDP allreduce path)")
    return shard, new_residual


def allgather_flat(x: torch.Tensor, group=None,
                   spec: Optional[CollectiveSpec] = None, *,
                   label: str = "allgather"):
    """Gather each rank's 1-D shard into the full concatenated fp32 buffer.
    ``bf16`` ships bf16; ``int8_blockscale`` ships the shard's (codes,
    scales) and dequantizes on arrival (gated by :func:`chaos_gate` under
    ``"<label>.int8_blockscale"``); ``adasum`` raises.  Returns ``(full,
    wire_bytes_per_rank, wire_dtype)``; the caller meters."""
    if spec is not None and spec.scheme == "adasum":
        raise ValueError("adasum is a reduction rule; it has no "
                         "allgather meaning")
    _check_flat(x, group, "allgather_flat")
    if spec is not None and spec.scheme == "int8_blockscale":
        chaos_gate(f"{label}.int8_blockscale")
        if x.shape[0] % spec.block:
            # a block that does not divide the shard would pad each shard
            # and interleave zeros into the flat buffer
            raise ValueError(
                f"int8_blockscale allgather needs block ({spec.block}) "
                f"to divide the shard length ({x.shape[0]})")
        q, scales = quantize_blockscale(x.to(torch.float32), spec.block)
        qg = _gather(q, group)
        sg = _gather(scales, group)
        full = (qg.to(torch.float32) * sg[:, None]).reshape(-1)
        return (full, wire_bytes("int8_blockscale", x.numel(), spec.block),
                "int8")
    if spec is not None and spec.scheme == "bf16":
        full = _gather(x.to(torch.bfloat16), group).to(torch.float32)
        return full, 2 * x.numel(), "bfloat16"
    return (_gather(x, group).to(torch.float32),
            x.numel() * x.element_size(), dtype_name(x.dtype))


def rechunk_flat(buf, *, used: int, total: int):
    """Re-slice a canonical flat buffer to a new chunk-padded length, the
    elastic-resume primitive: keep the first ``used`` elements, re-pad with
    zeros to ``total``.  A nonzero tail is real data the re-slice would
    destroy, so it raises.  Host side, on checkpoint payloads (numpy)."""
    a = np.asarray(buf).reshape(-1)
    used, total = int(used), int(total)
    if used > a.shape[0] or used > total:
        raise ValueError(
            f"rechunk_flat: used={used} exceeds the buffer ({a.shape[0]}) "
            f"or the target total ({total})")
    tail = a[used:]
    if tail.size and np.any(tail != 0):
        raise ValueError(
            f"rechunk_flat: buffer carries nonzero data beyond its used "
            f"length ({used} of {a.shape[0]}) — not a canonical flat "
            "buffer; refusing to truncate real data")
    out = np.zeros((total,), a.dtype)
    out[:used] = a[:used]
    return out


def launch_reduce(spec: CollectiveSpec, x: torch.Tensor, group=None, *,
                  residual: Optional[torch.Tensor] = None):
    """Start :func:`reduce` without waiting: ``(finish, new_residual)``,
    ``finish()`` giving the reduced tensor.  The overlapped DDP buckets
    launch here during the backward and finish after it."""
    info = get_scheme(spec.scheme)
    chaos_gate(f"collectives.{info.name}")
    residual = residual if info.stateful else None
    if info.launch is not None:
        return info.launch(x, group, spec.block, residual)
    out, new_res = info.reduce(x, group, spec.block, residual)
    return (lambda: out), new_res


def reduce(spec: CollectiveSpec, x: torch.Tensor, group=None, *,
           residual: Optional[torch.Tensor] = None):
    """Reduce one fp32 tensor over ``group`` under ``spec``'s scheme (no
    threshold here: callers route through :func:`leaf_scheme` first).
    Returns ``(reduced, new_residual)``; ``new_residual`` is None unless
    the scheme is stateful and a residual was passed."""
    finish, new_res = launch_reduce(spec, x, group, residual=residual)
    return finish(), new_res
