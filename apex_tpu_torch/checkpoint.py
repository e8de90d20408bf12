"""One-file checkpoints: model params, optimizer state, amp state and
anything else picklable, with the JAX package's on-disk record.

Counterpart of ``apex_tpu/checkpoint.py``::

    from apex_tpu_torch import amp, checkpoint
    checkpoint.save("ckpt.pkl", step=step, amp=amp.state_dict(st),
                    model=st.model_params, masters=st.master_params,
                    opt=st.opt_state, bn=bn_state)
    ckpt = checkpoint.load("ckpt.pkl")       # dict of numpy trees
    params = checkpoint.restore_like(st.model_params, ckpt["model"])

:func:`save` writes every tensor as a numpy array (bf16 ones as
``_pickle_compat.BF16``), streams the pickle through a CRC32 accumulator
into a temporary file, patches the header ``magic | length | crc32`` in
front of it and renames the file into place, so a save cut short never
replaces the previous checkpoint.  :func:`load` and :func:`verify` tell a
truncated or corrupt file from a good one and raise
:class:`CheckpointError`, never a bare ``UnpicklingError``; a legacy bare
pickle (no header) still loads.

The two packages read each other's files: this package writes its
optimizer states under the JAX package's class names and its bf16 leaves
as ``ml_dtypes.bfloat16`` arrays, and reads both back without importing
``apex_tpu`` or ``ml_dtypes`` (``apex_tpu_torch/_pickle_compat.py`` has
the table of names).

:func:`save_sharded` / :func:`load_sharded` are the counterparts of the
JAX package's orbax checkpoints over ``torch.distributed.checkpoint``; the
two packages do not share that format.
"""
from __future__ import annotations

import os
import pickle
import shutil
import struct
import tempfile
import time
import zlib
from typing import Any, Dict

import numpy as np
import torch

from . import _pickle_compat
from .utils.pytree import path_str, tree_flatten, tree_leaves_with_path, \
    tree_map, tree_unflatten

__all__ = ["CheckpointError", "save", "load", "verify", "restore_like",
           "save_sharded", "load_sharded"]


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable: truncated, checksum-mismatched, or
    not a checkpoint at all.  Resume code catches this one type and falls
    back to an older file (``resilience.ckpt.CheckpointManager``)."""


_MAGIC = b"APEXCKPT1\x00"
_HEADER = struct.Struct("<QI")          # payload length, CRC32
_CHUNK = 1 << 20


class _CrcWriter:
    """File proxy that accumulates CRC32 and length while the pickle
    streams to disk (no payload-sized copy in host memory)."""

    def __init__(self, fh):
        self._fh = fh
        self.crc = 0
        self.length = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        # nbytes, not len(): a large payload arrives as a buffer object
        # (PickleBuffer at protocol 5), which has no len()
        self.length += memoryview(b).nbytes
        return self._fh.write(b)


def _host_leaf(x):
    """A tensor as a C-contiguous numpy array (bf16 as its bits in
    ``_pickle_compat.BF16``); other leaves unchanged."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return _pickle_compat.bf16_to_numpy(x.view(torch.int16).numpy())
    return x.numpy()


def _to_host(tree):
    return tree_map(_host_leaf, tree)


def save(path: str, **entries: Any) -> None:
    """Atomically write ``entries`` (trees of tensors or picklable values)
    as a CRC-framed record (``magic | length | crc32 | pickle``)."""
    payload = {k: _to_host(v) for k, v in entries.items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt_tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_MAGIC + _HEADER.pack(0, 0))        # placeholder
            w = _CrcWriter(f)
            _pickle_compat.Pickler(
                w, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
            f.flush()
            f.seek(len(_MAGIC))
            f.write(_HEADER.pack(w.length, w.crc & 0xffffffff))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _crc_scan(f, path: str, length: int, crc: int) -> None:
    """Chunked CRC pass over the payload; raises on truncation or a
    mismatch and seeks back to the payload's start."""
    start = f.tell()
    actual, n = 0, 0
    while True:
        chunk = f.read(_CHUNK)
        if not chunk:
            break
        actual = zlib.crc32(chunk, actual)
        n += len(chunk)
    if n != length:
        raise CheckpointError(
            f"{path}: truncated checkpoint ({n} of {length} "
            f"payload bytes — an interrupted or partial write)")
    if actual & 0xffffffff != crc:
        raise CheckpointError(f"{path}: checkpoint checksum mismatch "
                              "(file corrupted on disk)")
    f.seek(start)


def _open_checked(f, path: str):
    """``f`` positioned at the pickle after the integrity checks: framed
    files get the CRC pass, a legacy bare pickle rewinds to 0, an empty
    file raises."""
    head = f.read(len(_MAGIC))
    if head == _MAGIC:
        hdr = f.read(_HEADER.size)
        if len(hdr) < _HEADER.size:
            raise CheckpointError(f"{path}: truncated checkpoint header")
        length, crc = _HEADER.unpack(hdr)
        _crc_scan(f, path, length, crc)
        return f
    if not head:
        raise CheckpointError(f"{path}: empty checkpoint file")
    f.seek(0)
    return f


def load(path: str) -> Dict[str, Any]:
    """The entries of a checkpoint as numpy trees (bf16 leaves in
    ``_pickle_compat.BF16``; :func:`restore_like` turns them into
    tensors).  Raises :class:`CheckpointError` for a truncated file, a
    checksum mismatch or content that does not unpickle."""
    with open(path, "rb") as f:
        src = _open_checked(f, path)
        try:
            return _pickle_compat.Unpickler(src).load()
        except Exception as e:
            raise CheckpointError(
                f"{path}: checkpoint payload does not unpickle "
                f"({type(e).__name__}: {e})") from e


def verify(path: str) -> None:
    """Header + CRC for a framed file (no unpickling), a whole
    :func:`load` for a legacy one.  Raises :class:`CheckpointError` (or
    ``OSError`` for an unreadable path)."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head == _MAGIC:
            hdr = f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                raise CheckpointError(f"{path}: truncated checkpoint header")
            length, crc = _HEADER.unpack(hdr)
            _crc_scan(f, path, length, crc)
            return
    load(path)


def _host_tensor(h) -> torch.Tensor:
    """A loaded leaf (numpy, bf16 bits or a scalar) as a CPU tensor."""
    a = np.asarray(h)
    if _pickle_compat.is_bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def restore_like(template, host_tree):
    """``host_tree`` (from :func:`load`) as tensors shaped, typed and
    placed like ``template``'s leaves: each leaf must have its template's
    shape (``ValueError`` otherwise), is cast to its dtype and lands on
    its device with its strides (a channels-last weight stays one)."""
    def put(t, h):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"template leaf {type(t).__name__} is not a "
                            "tensor")
        src = _host_tensor(h)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(src.shape)} != "
                             f"template {tuple(t.shape)}")
        return torch.empty_like(t).copy_(src)
    return tree_map(put, template, host_tree)


# ---------------------------------------------------------------------------
# torch.distributed.checkpoint: one directory, written by every rank
# ---------------------------------------------------------------------------

def _flat_dict(tree) -> Dict[str, torch.Tensor]:
    """{leaf path: tensor}, the flat dict ``torch.distributed.checkpoint``
    takes."""
    return {path_str(p) or "leaf": leaf
            for p, leaf in tree_leaves_with_path(tree)}


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _barrier():
    d = _dist()
    if d is not None:
        d.barrier()


def save_sharded(path: str, tree) -> None:
    """Write ``tree`` (a tree of tensors, the same on every rank) as a
    ``torch.distributed.checkpoint`` directory at ``path``.

    Every rank of the default group calls it.  The new directory is
    written beside ``path`` (``path.new``) and swapped in by rank 0
    between two barriers, so a save cut short leaves the previous
    checkpoint at ``path`` (or, between the two renames, at ``path.old``,
    which :func:`load_sharded` and the next save take back).  No format is
    shared with the JAX package's orbax directories."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    tmp = f"{path}.new"
    d = _dist()
    lead = d is None or d.get_rank() == 0
    if lead:
        if not os.path.exists(path) and os.path.exists(f"{path}.old"):
            os.rename(f"{path}.old", path)
        # a leftover of a save cut short; age-gated, so another job's live
        # write (an unsupported layout) is not removed under it
        if os.path.exists(tmp) and time.time() - _newest_mtime(tmp) > 60.0:
            shutil.rmtree(tmp, ignore_errors=True)
    _barrier()
    dcp.save(_flat_dict(tree), checkpoint_id=tmp, no_dist=d is None)
    try:
        if lead:
            if os.path.exists(path):
                old = f"{path}.old"
                shutil.rmtree(old, ignore_errors=True)
                os.rename(path, old)
                os.rename(tmp, path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, path)
    finally:
        _barrier()


def _newest_mtime(root: str) -> float:
    newest = os.path.getmtime(root)
    for parent, _dirs, files in os.walk(root):
        for name in files:
            try:
                newest = max(newest, os.path.getmtime(
                    os.path.join(parent, name)))
            except OSError:
                pass
    return newest


def load_sharded(path: str, template):
    """A :func:`save_sharded` directory read into new tensors shaped,
    typed and placed like ``template``'s leaves (every rank calls it)."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(f"{path}.old"):
        path = f"{path}.old"
    leaves, treedef = tree_flatten(template)
    out = [torch.empty_like(t) for t in leaves]
    dcp.load(_flat_dict(tree_unflatten(treedef, out)), checkpoint_id=path,
             no_dist=_dist() is None)
    return tree_unflatten(treedef, out)
