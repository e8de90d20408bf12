"""Seekable, shard-addressed datasets: the data plane that makes a
resume replay the stream bit for bit on data read from disk.

Counterpart of ``apex_tpu/data/sharded.py``; numpy on the host, nothing of
torch (a ``transform`` puts batches on a device).  Three layers:

  * **Index + checksums** — a dataset is a directory of ``.npz`` shards
    plus an ``INDEX.json`` listing every shard with its record count and
    CRC32 (:func:`build_index`).  Checksums are verified lazily when a
    shard is first opened and eagerly by :meth:`ShardedDataset.verify`;
    a mismatch is the typed :class:`ShardChecksumError` naming the shard
    and the record offset the failing read wanted.  A missing or corrupt
    index degrades to a directory scan with :class:`IndexMissingWarning`;
    the scan recomputes the same rows, so the index
    :attr:`~ShardIndex.digest` (the dataset's identity in a checkpoint
    manifest) survives.
  * **Pure addressing** — :func:`global_records` maps ``(seed, step)`` to
    the record ids of the global batch with no dependence on the host
    count (a per-epoch permutation seeded by ``(seed, epoch)``, sliced by
    the step's position in the epoch, drop-last); :func:`host_records`
    slices it for one of ``world`` ingest hosts and :func:`locate_step`
    maps the slice to ``(shard, offset)`` pairs.
  * **Seekable loading** — :class:`ShardedLoader`: ``loader(step)`` is
    seek-to-step (bitwise the batch sequential iteration gives there);
    ``iter(loader)`` prefetches on a background fill thread over a
    bounded queue with the loader's timed wait, ``loader_stall`` faults
    and bounded retries before :class:`~apex_tpu_torch.data.loader.
    LoaderStallError`.  ``cursor(step)`` and ``data_meta()`` go into the
    checkpoint manifest (``resilience.ckpt.META_DATA_KEY``).

The JAX package and this one compute the same ``INDEX.json`` digest, the
same record ids per (seed, step, world, host) and the same batch bytes
for one directory.  Telemetry and fault probes are local imports.
"""
from __future__ import annotations

import dataclasses
import io
import json
import hashlib
import os
import warnings
import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import events as _tel_events

INDEX = "INDEX.json"


class ShardChecksumError(RuntimeError):
    """A shard's bytes do not match the indexed CRC32 (bit rot, a
    truncated copy, or an injected ``shard_corrupt`` fault).  Carries
    ``shard`` (file name) and ``offset`` (the record offset within the
    shard the failing read wanted; None for a whole-shard
    :meth:`ShardedDataset.verify` sweep) so the operator knows exactly
    what to re-fetch."""

    def __init__(self, shard: str, offset: Optional[int],
                 expected: int, actual: int):
        self.shard = str(shard)
        self.offset = None if offset is None else int(offset)
        self.expected = int(expected)
        self.actual = int(actual)
        where = ("(whole-shard verify sweep)" if offset is None
                 else f"at record offset {int(offset)}")
        super().__init__(
            f"shard {shard!r} checksum mismatch {where}: crc32 "
            f"0x{actual & 0xffffffff:08x} != indexed "
            f"0x{expected & 0xffffffff:08x} — the shard bytes changed "
            "since build_index(); refusing to feed corrupt records to "
            "training")


class IndexMissingWarning(UserWarning):
    """``INDEX.json`` is missing or unreadable: the dataset degraded to
    a directory scan (record counts + checksums recomputed from the
    shard bytes).  The scan rebuilds identical rows, so the dataset
    digest — and therefore manifest-cursor resume — survives the loss;
    rewrite the index with :func:`build_index` to stop paying the scan."""


class DatasetError(ValueError):
    """The shard set itself is unusable (no shards, ragged keys,
    or an addressing request the dataset cannot satisfy)."""


# ---------------------------------------------------------------------------
# index: per-shard CRC32 rows + the dataset digest
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """One shard row: ``file`` (basename), ``n`` records, ``crc32`` of
    the raw file bytes."""
    file: str
    n: int
    crc32: int


@dataclasses.dataclass(frozen=True)
class ShardIndex:
    """The parsed dataset index.  ``digest`` is a sha256 over the
    canonical shard rows — the dataset's identity, recorded in the
    checkpoint manifest so a resume can prove it is seeking the SAME
    stream it checkpointed."""
    directory: str
    keys: Tuple[str, ...]
    shards: Tuple[ShardInfo, ...]
    digest: str

    @property
    def n_records(self) -> int:
        return sum(s.n for s in self.shards)

    @property
    def starts(self) -> np.ndarray:
        """First global record id of each shard (cumulative counts)."""
        return np.concatenate(
            [[0], np.cumsum([s.n for s in self.shards])])[:-1]

    def locate(self, record_id: int) -> Tuple[int, int]:
        """``record_id`` -> ``(shard_idx, offset_within_shard)``."""
        rid = int(record_id)
        if not 0 <= rid < self.n_records:
            raise DatasetError(f"record id {rid} outside dataset "
                               f"(n_records={self.n_records})")
        starts = self.starts
        i = int(np.searchsorted(starts, rid, side="right")) - 1
        return i, rid - int(starts[i])

    def path_for(self, shard_idx: int) -> str:
        return os.path.join(self.directory, self.shards[shard_idx].file)


def _digest(rows: Sequence[dict]) -> str:
    return hashlib.sha256(
        json.dumps(rows, sort_keys=True).encode()).hexdigest()


def _scan_shard(path: str) -> Tuple[int, int, List[str]]:
    """(crc32, n_records, sorted keys) from one shard's raw bytes."""
    with open(path, "rb") as f:
        raw = f.read()
    crc = zlib.crc32(raw)
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        keys = sorted(z.files)
        if not keys:
            raise DatasetError(f"shard {path!r} holds no arrays")
        ns = {k: int(z[k].shape[0]) for k in keys}
    if len(set(ns.values())) != 1:
        raise DatasetError(
            f"shard {path!r} arrays disagree on the record dim: {ns}")
    return crc, next(iter(ns.values())), keys


def _index_from_rows(directory: str, keys, rows: List[dict]) -> ShardIndex:
    return ShardIndex(
        directory=os.path.abspath(directory), keys=tuple(keys),
        shards=tuple(ShardInfo(r["file"], int(r["n"]), int(r["crc32"]))
                     for r in rows),
        digest=_digest(rows))


def _scan_rows(directory: str) -> Tuple[List[str], List[dict]]:
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
    if not files:
        raise DatasetError(f"no .npz shards under {directory!r}")
    rows, keys = [], None
    for fn in files:
        crc, n, k = _scan_shard(os.path.join(directory, fn))
        if keys is None:
            keys = k
        elif k != keys:
            raise DatasetError(
                f"shard {fn!r} keys {k} != {keys} — a dataset's shards "
                "must agree on their array names")
        rows.append({"file": fn, "n": n, "crc32": crc})
    return keys, rows


def build_index(directory: str) -> ShardIndex:
    """Scan ``directory``'s ``.npz`` shards (sorted by name), compute
    per-shard record counts + CRC32 checksums, write ``INDEX.json``
    atomically, and return the :class:`ShardIndex`."""
    keys, rows = _scan_rows(directory)
    idx = _index_from_rows(directory, keys, rows)
    doc = {"version": 1, "keys": list(keys), "shards": rows,
           "n_records": idx.n_records, "digest": idx.digest}
    path = os.path.join(directory, INDEX)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return idx


_OPEN_CALLS = {"n": 0}    # index_missing faults count dataset opens


def _fault_index_missing() -> bool:
    """``index_missing`` fault probe (one-shot, counted per
    :func:`load_index` call like ``wrap_collective``'s call index):
    True when the scheduled open must behave as if INDEX.json is gone."""
    try:
        from ..resilience import faults as _faults
    except ImportError:      # the module used on its own
        return False
    i = _OPEN_CALLS["n"]
    _OPEN_CALLS["n"] += 1
    p = _faults.active_plan()
    return p is not None and p.fire("index_missing", i) is not None


def load_index(directory: str) -> ShardIndex:
    """Read ``INDEX.json`` (one stat + one small JSON read).  Missing or
    unreadable — or an injected ``index_missing`` fault — degrades to a
    :func:`build_index`-equivalent directory scan (checksums recomputed,
    nothing written) with a typed :class:`IndexMissingWarning`: the
    index is an index, never the only copy of the truth."""
    path = os.path.join(directory, INDEX)
    doc = None
    if not _fault_index_missing():
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = None
    if isinstance(doc, dict):
        rows = doc.get("shards")
        keys = doc.get("keys")
        if (isinstance(rows, list) and isinstance(keys, list) and rows
                and all(isinstance(r, dict) and isinstance(r.get("file"),
                                                           str)
                        and isinstance(r.get("n"), int)
                        and isinstance(r.get("crc32"), int)
                        for r in rows)):
            return _index_from_rows(directory, keys, rows)
    warnings.warn(
        f"dataset index {path!r} missing or unreadable: degrading to a "
        "directory scan (record counts + checksums recomputed from the "
        "shard bytes; same digest, so manifest-cursor resume still "
        "works) — rewrite it with apex_tpu_torch.data.build_index()",
        IndexMissingWarning, stacklevel=2)
    keys, rows = _scan_rows(directory)
    return _index_from_rows(directory, keys, rows)


# ---------------------------------------------------------------------------
# pure addressing: (seed, epoch, step, world) -> record ids -> (shard, offset)
# ---------------------------------------------------------------------------

def steps_per_epoch(n_records: int, global_batch: int) -> int:
    """Full batches per epoch (drop-last)."""
    if global_batch < 1:
        raise DatasetError(f"global_batch must be >= 1, got {global_batch}")
    if n_records < global_batch:
        raise DatasetError(
            f"dataset has {n_records} records < global_batch "
            f"{global_batch}: not even one full batch per epoch")
    return n_records // global_batch


def epoch_permutation(seed: int, epoch: int, n_records: int) -> np.ndarray:
    """The per-epoch record shuffle — pure in ``(seed, epoch)``; PCG64
    is platform-stable, so every host computes the same order."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed), int(epoch)])))
    return rng.permutation(n_records)


def global_records(seed: int, step: int, n_records: int,
                   global_batch: int) -> np.ndarray:
    """Record ids of global step ``step``'s GLOBAL batch.  Depends only
    on ``(seed, epoch, step)`` — never on the host count — which is the
    whole elastic guarantee: the stream a resized fleet re-partitions is
    the SAME stream, record for record."""
    spe = steps_per_epoch(n_records, global_batch)
    epoch, k = divmod(int(step), spe)
    perm = epoch_permutation(seed, epoch, n_records)
    return perm[k * global_batch:(k + 1) * global_batch]


def host_records(seed: int, step: int, n_records: int, global_batch: int,
                 world: int = 1, host: int = 0) -> np.ndarray:
    """``host``'s contiguous slice of the global batch under ``world``
    ingest hosts.  Concatenating the slices over hosts reproduces
    :func:`global_records` exactly for ANY world that divides the
    batch — the no-drop/no-dup re-partition property."""
    world, host = int(world), int(host)
    if world < 1 or not 0 <= host < world:
        raise DatasetError(f"bad host/world pair ({host}, {world})")
    if global_batch % world:
        raise DatasetError(
            f"global_batch {global_batch} must divide over world {world}")
    ids = global_records(seed, step, n_records, global_batch)
    per = global_batch // world
    return ids[host * per:(host + 1) * per]


def locate_step(index: ShardIndex, seed: int, step: int, global_batch: int,
                world: int = 1, host: int = 0) -> List[Tuple[int, int]]:
    """The ``(seed, epoch, step, world) -> (shard, offset)`` addressing
    function: the concrete shard positions of every record ``host``
    reads for global step ``step``."""
    return [index.locate(r) for r in
            host_records(seed, step, index.n_records, global_batch,
                         world, host)]


# ---------------------------------------------------------------------------
# the dataset: checksum-verified shard reads
# ---------------------------------------------------------------------------

def _record_checksum_failure(shard: str, offset: Optional[int]) -> None:
    """Telemetry hook (loader.py pattern): one ``data.checksum_failed``
    event through the default registry/tracer before the typed error
    propagates."""
    _tel_events.record_shard_checksum(shard, offset)


class ShardedDataset:
    """Checksum-verified reads over an indexed shard directory.

    Shards are loaded lazily (raw bytes -> CRC32 check against the
    index -> ``np.load``) and cached up to ``cache_shards`` at a time
    (LRU).  :meth:`verify` is the eager sweep; :meth:`gather` assembles
    a batch from global record ids.
    """

    def __init__(self, directory: str, *, index: Optional[ShardIndex] = None,
                 cache_shards: int = 4):
        self.index = index if index is not None else load_index(directory)
        self.cache_shards = max(1, int(cache_shards))
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = \
            OrderedDict()

    @property
    def n_records(self) -> int:
        return self.index.n_records

    @property
    def keys(self) -> Tuple[str, ...]:
        return self.index.keys

    def evict(self, shard_idx: int) -> None:
        self._cache.pop(int(shard_idx), None)

    def _load_shard(self, shard_idx: int, *, offset: Optional[int] = None,
                    flip_at: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Verified arrays of one shard.  ``offset`` names the record
        the caller wanted (for the error).  ``flip_at`` is the
        ``shard_corrupt`` fault's in-memory byte flip — the on-disk
        shard is never touched, so the fault is one-shot like every
        other kind."""
        info = self.index.shards[shard_idx]
        cached = self._cache.get(shard_idx)
        if cached is not None and flip_at is None:
            self._cache.move_to_end(shard_idx)
            return cached
        with open(self.index.path_for(shard_idx), "rb") as f:
            raw = bytearray(f.read())
        if flip_at is not None and raw:
            pos = len(raw) // 2 if flip_at < 0 else int(flip_at) % len(raw)
            raw[pos] ^= 0xFF
        crc = zlib.crc32(bytes(raw))
        if crc != (info.crc32 & 0xffffffff):
            _record_checksum_failure(info.file, offset)
            raise ShardChecksumError(info.file, offset, info.crc32, crc)
        with np.load(io.BytesIO(bytes(raw)), allow_pickle=False) as z:
            arrs = {k: z[k] for k in self.index.keys}
        if any(a.shape[0] != info.n for a in arrs.values()):
            raise DatasetError(
                f"shard {info.file!r} record count changed since "
                "build_index() (index is stale)")
        self._cache[shard_idx] = arrs
        self._cache.move_to_end(shard_idx)
        while len(self._cache) > self.cache_shards:
            self._cache.popitem(last=False)
        return arrs

    def verify(self) -> int:
        """Eager checksum sweep over every shard (streaming byte reads,
        nothing cached).  Returns the shard count; raises
        :class:`ShardChecksumError` on the first mismatch."""
        for i, info in enumerate(self.index.shards):
            crc = 0
            with open(self.index.path_for(i), "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
            if crc != (info.crc32 & 0xffffffff):
                _record_checksum_failure(info.file, None)
                raise ShardChecksumError(info.file, None, info.crc32, crc)
        return len(self.index.shards)

    def gather(self, record_ids: np.ndarray, *,
               corrupt_flip_at: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
        """Assemble ``{key: stacked rows}`` for ``record_ids`` (order
        preserved).  ``corrupt_flip_at`` applies the injected
        ``shard_corrupt`` byte flip to the first record's shard before
        its checksum is verified — the verification, not the training
        step, is what must catch it."""
        located = [self.index.locate(r) for r in record_ids]
        out: Dict[str, List[np.ndarray]] = {k: [] for k in self.index.keys}
        corrupt_shard = located[0][0] if located else None
        for pos, (si, off) in enumerate(located):
            flip = (corrupt_flip_at if corrupt_flip_at is not None
                    and si == corrupt_shard else None)
            if flip is not None:
                self.evict(si)        # force the corrupted re-read
            arrs = self._load_shard(si, offset=off, flip_at=flip)
            for k in self.index.keys:
                out[k].append(arrs[k][off])
        return {k: np.stack(v) for k, v in out.items()}


def open_dataset(directory: str, *, write_index: bool = True,
                 cache_shards: int = 4) -> ShardedDataset:
    """:class:`ShardedDataset` over ``directory``, writing ``INDEX.json``
    first when it is absent (``write_index=True``; a read-only directory
    degrades to :func:`load_index`'s warned scan) — the one-call entry
    point the imagenet example's loader uses."""
    if write_index and not os.path.exists(os.path.join(directory, INDEX)):
        try:
            return ShardedDataset(directory, index=build_index(directory),
                                  cache_shards=cache_shards)
        except OSError:
            pass
    return ShardedDataset(directory, cache_shards=cache_shards)


# ---------------------------------------------------------------------------
# the loader protocol: batches(step), prefetched iteration, manifest cursor
# ---------------------------------------------------------------------------

class ShardedLoader:
    """The seekable loader protocol.

    ``loader(step)`` returns global step ``step``'s batch for this
    host — computed, not streamed, so it IS seek-to-step and replays
    bitwise for resume/rollback.  ``iter(loader)`` walks
    ``[start_step, num_steps)`` with a background fill thread over a
    bounded queue: ``loader.fill`` spans producer-side, ``loader.wait``
    + queue-depth gauges consumer-side (through the default registry
    and tracer, when installed), injected ``loader_stall``
    faults inside the timed wait, bounded retry/backoff, then
    :class:`~apex_tpu_torch.data.loader.LoaderStallError`.

    ``transform(batch_dict, step)`` post-processes each assembled batch
    (dtype casts, device_put) on the FILL thread during iteration and
    inline on ``loader(step)``; it must stay pure in its inputs or the
    seek-equals-sequential property is forfeit.

    ``cursor(step)`` / ``data_meta()`` are the manifest hooks a resume
    records (``CheckpointManager.set_meta`` / ``update_meta``) so it
    seeks the stream instead of restarting it.
    """

    def __init__(self, dataset: ShardedDataset, *, global_batch: int,
                 seed: int = 0, world: int = 1, host: int = 0,
                 num_steps: Optional[int] = None,
                 epochs: Optional[int] = None,
                 transform: Optional[Callable] = None,
                 depth: int = 3, wait_timeout: Optional[float] = None,
                 stall_retries: int = 2, plan=None):
        if isinstance(dataset, str):
            dataset = ShardedDataset(dataset)
        self.dataset = dataset
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.world = int(world)
        self.host = int(host)
        self.transform = transform
        self.depth = int(depth)
        self.wait_timeout = (None if wait_timeout is None
                             else float(wait_timeout))
        self.stall_retries = int(stall_retries)
        self._plan = plan
        # validate addressing once, loudly, at construction
        self.steps_per_epoch = steps_per_epoch(dataset.n_records,
                                               self.global_batch)
        host_records(self.seed, 0, dataset.n_records, self.global_batch,
                     self.world, self.host)
        if num_steps is not None and epochs is not None:
            raise DatasetError("pass num_steps or epochs, not both")
        if epochs is not None:
            num_steps = int(epochs) * self.steps_per_epoch
        self.num_steps = None if num_steps is None else int(num_steps)
        self._start = 0
        self._perm_cache: Tuple[int, Optional[np.ndarray]] = (-1, None)

    # -- addressing --------------------------------------------------------
    def _records(self, step: int) -> np.ndarray:
        spe = self.steps_per_epoch
        epoch, k = divmod(int(step), spe)
        if self._perm_cache[0] != epoch:
            self._perm_cache = (epoch, epoch_permutation(
                self.seed, epoch, self.dataset.n_records))
        perm = self._perm_cache[1]
        ids = perm[k * self.global_batch:(k + 1) * self.global_batch]
        per = self.global_batch // self.world
        return ids[self.host * per:(self.host + 1) * per]

    def _active_plan(self):
        if self._plan is not None:
            return self._plan
        try:
            from ..resilience import faults as _faults
        except ImportError:  # the module used on its own
            return None
        return _faults.active_plan()

    def batch_at(self, step: int):
        """Assemble (and transform) global step ``step``'s batch.  The
        seek primitive: pure in ``(seed, step, world, host)`` plus the
        shard bytes, which the per-shard CRC proves unchanged."""
        ids = self._records(step)
        flip = None
        p = self._active_plan()
        if p is not None:
            spec = p.fire("shard_corrupt", int(step))
            if spec is not None:
                # ARG = byte offset to flip; default (-1) lands mid-file,
                # past the npz header, so the flip hits payload bytes
                flip = int(spec.arg) if spec.arg else -1
        batch = self.dataset.gather(ids, corrupt_flip_at=flip)
        if self.transform is not None:
            return self.transform(batch, int(step))
        return batch

    # -- manifest hooks ----------------------------------------------------
    def data_meta(self) -> dict:
        """Run-level data-plane facts for the checkpoint manifest."""
        return {"kind": "sharded", "index_digest": self.dataset.index.digest,
                "n_records": self.dataset.n_records,
                "global_batch": self.global_batch, "seed": self.seed,
                "world": self.world,
                "steps_per_epoch": self.steps_per_epoch}

    @property
    def index_digest(self) -> str:
        return self.dataset.index.digest

    def cursor(self, step: int) -> dict:
        """The data-plane cursor at global step ``step``: epoch, step
        within the epoch, and the shard/offset of the step's first
        record — everything a resume needs to prove it re-seeks the
        same position in the same stream."""
        spe = self.steps_per_epoch
        epoch, k = divmod(int(step), spe)
        cur = {"step": int(step), "epoch": int(epoch), "epoch_step": int(k),
               "index_digest": self.dataset.index.digest}
        ids = self._records(step)
        if len(ids):
            si, off = self.dataset.index.locate(int(ids[0]))
            cur["shard"] = self.dataset.index.shards[si].file
            cur["shard_offset"] = int(off)
        return cur

    def seek(self, step: int) -> None:
        """Position the NEXT ``iter(loader)`` at global step ``step``
        (resume semantics; ``loader(step)`` needs no seek at all)."""
        self._start = int(step)

    # -- prefetched iteration (the loader's queue/telemetry machinery) -----
    def __iter__(self):
        from .loader import (_fault_stall, _note_fill_span,
                             _put_checking_stop, _record_loader, _timed_get)
        import queue as _q
        import threading
        import time as _time

        if self.num_steps is None:
            raise DatasetError(
                "iterating a ShardedLoader needs num_steps/epochs; "
                "the batches(step) call form has no horizon")
        q: "_q.Queue" = _q.Queue(maxsize=self.depth)
        stop = threading.Event()
        start = self._start

        def producer():
            try:
                for t in range(start, self.num_steps):
                    if stop.is_set():
                        return
                    t0 = _time.perf_counter()
                    b = self.batch_at(t)
                    _note_fill_span(t, _time.perf_counter() - t0)
                    if not _put_checking_stop(q, b, stop):
                        return
                _put_checking_stop(q, None, stop)
            except BaseException as e:   # surface to the consumer: a dead
                # producer with no sentinel would hang training forever
                _put_checking_stop(q, e, stop)

        th = threading.Thread(target=producer, daemon=True,
                              name="apex-tpu-torch-sharded-fill")
        th.start()
        try:
            for step in range(start, self.num_steps):
                item, wait = _timed_get(
                    q, step, self.wait_timeout, self.stall_retries)
                _record_loader(q.qsize(), wait)
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


# bind the callable protocol: loader(step) == loader.batch_at(step)
ShardedLoader.__call__ = ShardedLoader.batch_at
