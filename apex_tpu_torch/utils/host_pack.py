"""Threaded host packing of array lists into one flat buffer and back: the
``apex_C.flatten`` / ``unflatten`` runtime analog.

Counterpart of ``apex_tpu/utils/host_pack.py``.  The native engine is the
port's own ``apex_tpu_torch/csrc/host_pack.cpp`` (a threaded ``memcpy``,
no kernel), built with the host C++ compiler at first use by
:func:`apex_tpu_torch.utils.build.host_pack_library`; with no host
compiler every call takes the numpy copy, so the API is always live::

    from apex_tpu_torch.utils import host_pack
    flat = host_pack.pack(arrays, offsets, total)      # one buffer
    host_pack.unpack(flat, arrays_out, offsets)        # in-place fill

Its user is :class:`apex_tpu_torch.interop.TorchFusedOptimizer`'s CPU
path: a torch loop's fp32 gradients and parameters packed into the flat
optimizer's layout (:func:`pack_like_flattener`), the master unpacked back
into the parameters' storage.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from . import build

__all__ = ["native_available", "pack", "unpack", "pack_like_flattener"]


def native_available() -> bool:
    """Is the native engine built and loaded (else numpy copies)?"""
    return build.host_pack_library() is not None


def _as_i64(vals) -> "ctypes.Array":
    return (ctypes.c_int64 * len(vals))(*vals)


def pack(arrays: Sequence[np.ndarray], offsets: Sequence[int], total: int,
         dtype=np.float32, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack host arrays into one (total,) buffer at ELEMENT offsets.  The
    arrays are cast to ``dtype``; padding gaps are zeroed.

    ``out``: a staging buffer to reuse, (total,) of ``dtype`` and
    C-contiguous; a fresh zeroed buffer a call costs page faults on the
    order of the copies themselves.  Gap elements keep what the buffer
    held, zeros when it started as ``np.zeros`` and only ever saw
    :func:`pack`."""
    dtype = np.dtype(dtype)
    if out is None:
        out = np.zeros((total,), dtype)
    elif out.shape != (total,) or out.dtype != dtype:
        raise ValueError(f"out buffer {out.shape}/{out.dtype} != "
                         f"({total},)/{dtype}")
    elif not out.flags["C_CONTIGUOUS"]:
        # the native copies run against out's base pointer as a dense
        # buffer: a strided view would be written wrongly
        raise ValueError("out buffer must be C-contiguous")
    arrays = [np.ascontiguousarray(a, dtype).reshape(-1) for a in arrays]
    if len(arrays) != len(offsets):
        raise ValueError(f"{len(arrays)} arrays vs {len(offsets)} offsets")
    for a, off in zip(arrays, offsets):
        if off < 0 or off + a.size > total:
            raise ValueError(
                f"span [{off}, {off + a.size}) exceeds total {total}")
    lib = build.host_pack_library()
    if lib is None:
        for a, off in zip(arrays, offsets):
            out[off:off + a.size] = a
        return out
    srcs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    lib.apex_torch_host_pack(srcs, _as_i64([a.size for a in arrays]),
                             _as_i64(list(offsets)), len(arrays),
                             out.ctypes.data_as(ctypes.c_void_p),
                             dtype.itemsize)
    return out


def unpack(flat: np.ndarray, outs: List[np.ndarray],
           offsets: Sequence[int]) -> None:
    """Fill ``outs`` in place from ELEMENT offsets of ``flat`` (same
    dtype)."""
    flat = np.ascontiguousarray(flat)
    if len(outs) != len(offsets):
        raise ValueError(f"{len(outs)} outputs vs {len(offsets)} offsets")
    for o, off in zip(outs, offsets):
        if off < 0 or off + o.size > flat.size:
            raise ValueError(
                f"span [{off}, {off + o.size}) exceeds flat {flat.size}")
    lib = build.host_pack_library()
    if lib is None:
        for o, off in zip(outs, offsets):
            np.copyto(o.reshape(-1), flat[off:off + o.size])
        return
    for o in outs:
        if not o.flags["C_CONTIGUOUS"]:
            raise ValueError("unpack targets must be contiguous")
        if o.dtype.itemsize != flat.dtype.itemsize:
            raise ValueError("unpack dtype width mismatch")
    dsts = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
    lib.apex_torch_host_unpack(flat.ctypes.data_as(ctypes.c_void_p),
                               _as_i64([o.size for o in outs]),
                               _as_i64(list(offsets)), len(outs), dsts,
                               flat.dtype.itemsize)


def pack_like_flattener(arrays, flattener, dtype=np.float32,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack host arrays in a :class:`~apex_tpu_torch.multi_tensor_apply.
    TreeFlattener`'s layout (its offsets and total): the flat buffer a
    ``step_flat`` takes."""
    offs = [int(o) for o in flattener.offsets[:-1]]
    return pack(arrays, offs, flattener.total, dtype, out=out)
