"""Rotating checkpoints with a manifest resume protocol.

Counterpart of ``apex_tpu/resilience/ckpt.py``, over the CRC-framed
records of ``apex_tpu_torch.checkpoint``:

  * ``keep_last=N`` rotation, never deleting the file a resume would need;
  * ``MANIFEST.json`` (written atomically) naming every live checkpoint
    and its step, plus run-level ``meta`` (manifest version 2);
  * :meth:`CheckpointManager.latest` / :meth:`~CheckpointManager.
    load_latest` verify candidates newest first and skip corrupt or
    partial files.

File names and the manifest's JSON are the JAX package's, so either
package resumes from a directory the other wrote::

    mgr = CheckpointManager("ckpts", keep_last=3)
    mgr.save(step, {"step": step, "model": params, "opt": opt_state})
    found = mgr.load_latest()          # -> (step, payload) or None
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import checkpoint as _ckpt
from ..checkpoint import CheckpointError

MANIFEST = "MANIFEST.json"

#: manifest meta keys an elastic reshard needs (``layout`` is the
#: ``ShardedUpdate.layout_meta`` dict: chunk pin, flat total, used
#: prefix, shard offsets)
META_LAYOUT_KEY = "layout"
META_WORLD_KEY = "world_size"
META_PLAN_KEY = "plan"
#: the data-plane block (``data/sharded.py``): the loader's ``data_meta()``
#: facts (index digest, n_records, global_batch, seed, ingest world)
#: plus the latest checkpoint's ``cursor`` (epoch / epoch_step / shard
#: position) — what lets a resume SEEK the stream instead of
#: restarting it, and an elastic resize re-partition the same stream
META_DATA_KEY = "data"


class WorldSizeMismatchError(CheckpointError):
    """A checkpoint written at one world size is being resumed at
    another, with no elastic reshard to carry it across.
    Carries both counts so the operator sees exactly what changed."""

    def __init__(self, saved_world: int, live_world: int,
                 detail: str = ""):
        self.saved_world = int(saved_world)
        self.live_world = int(live_world)
        msg = (f"checkpoint was written at world size {saved_world} but "
               f"this run has world size {live_world}; resuming across "
               "a device-count change needs an elastic reshard, which "
               "apex_tpu_torch does not have yet — a blind restore would "
               "produce garbage optimizer shards, not a training run")
        if detail:
            msg += f" [{detail}]"
        super().__init__(msg)


class DataStreamMismatchError(CheckpointError):
    """The checkpoint manifest records a data-plane cursor for a
    DIFFERENT dataset than the one this run is feeding from (the index
    digests disagree).  Seeking a changed stream would silently void
    the bitwise replay guarantee, so the mismatch is loud and typed —
    re-point the run at the original shard set, or start a fresh
    checkpoint directory for the new one."""

    def __init__(self, saved_digest: str, live_digest: str):
        self.saved_digest = str(saved_digest)
        self.live_digest = str(live_digest)
        super().__init__(
            "checkpoint manifest records data-plane cursor for dataset "
            f"index digest {saved_digest[:16]}… but the live loader "
            f"feeds from {live_digest[:16]}… — the dataset changed "
            "under the checkpoint; seek-to-step on a different stream "
            "would silently break the bitwise replay guarantee")


class ManifestCompatWarning(UserWarning):
    """The manifest predates the elastic metadata (an older writer): no
    world size / flat-shard layout recorded, so resharding is unavailable
    and only a same-world resume is possible."""


class CheckpointManager:
    """Rotating, manifest-tracked checkpoints in one directory.

    ``meta`` (or :meth:`set_meta`) attaches run-level facts to the
    manifest — the live world size, the active plan knobs, and the
    flat-shard layout — which an elastic reshard reads at resume to
    decide whether (and how) to reshard across a device-count change.
    A manifest written before these fields existed simply reads back an
    empty meta (:meth:`manifest_meta`) — degrade, never KeyError."""

    def __init__(self, directory: str, *, keep_last: int = 3,
                 prefix: str = "ckpt", meta: Optional[Dict[str, Any]] = None):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = os.path.abspath(directory)
        self.keep_last = int(keep_last)
        self.prefix = prefix
        self.meta: Dict[str, Any] = dict(meta or {})
        self._lock = threading.Lock()

    def set_meta(self, meta: Optional[Dict[str, Any]]) -> None:
        """Replace the manifest meta written by subsequent saves."""
        with self._lock:
            self.meta = dict(meta or {})

    def update_meta(self, patch: Dict[str, Any]) -> None:
        """Merge ``patch`` into the manifest meta (the guard's per-save
        data-plane cursor refresh — run-level facts stay, the cursor
        advances)."""
        with self._lock:
            self.meta.update(patch)

    # -- paths ---------------------------------------------------------------
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}-{int(step):010d}.ckpt")

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    # -- manifest ------------------------------------------------------------
    def _read_manifest(self) -> List[Dict[str, Any]]:
        """Manifest rows (step/file/ts), oldest first.  A missing or
        corrupt manifest degrades to a directory scan — the manifest is
        an index, never the only copy of the truth."""
        try:
            with open(self._manifest_path()) as f:
                doc = json.load(f)
            rows = doc.get("checkpoints")
            if isinstance(rows, list) and all(
                    isinstance(r, dict) and isinstance(r.get("step"), int)
                    and isinstance(r.get("file"), str) for r in rows):
                return sorted(rows, key=lambda r: r["step"])
        except (OSError, ValueError):
            pass
        return self._scan_rows()

    def _scan_rows(self) -> List[Dict[str, Any]]:
        rows = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return rows
        head, tail = f"{self.prefix}-", ".ckpt"
        for name in names:
            if not (name.startswith(head) and name.endswith(tail)):
                continue
            digits = name[len(head):-len(tail)]
            if digits.isdigit():
                rows.append({"step": int(digits), "file": name})
        return sorted(rows, key=lambda r: r["step"])

    def _write_manifest(self, rows: List[Dict[str, Any]]) -> None:
        doc: Dict[str, Any] = {"version": 2, "checkpoints": rows}
        if self.meta:
            doc["meta"] = self.meta
        path = self._manifest_path()
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    # -- save + rotation -----------------------------------------------------
    def save(self, step: int, payload: Dict[str, Any]) -> str:
        """Atomically write ``payload`` as the checkpoint for ``step``,
        update the manifest, and rotate files beyond ``keep_last``
        (oldest first).  Returns the checkpoint path."""
        path = self.path_for(step)
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            _ckpt.save(path, **payload)
            rows = [r for r in self._read_manifest()
                    if r["step"] != int(step)]
            rows.append({"step": int(step),
                         "file": os.path.basename(path),
                         "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             time.gmtime())})
            rows.sort(key=lambda r: r["step"])
            while len(rows) > self.keep_last:
                victim = rows.pop(0)
                try:
                    os.unlink(os.path.join(self.directory, victim["file"]))
                except OSError:
                    pass
            self._write_manifest(rows)
        return path

    # -- resume protocol -----------------------------------------------------
    def manifest_meta(self) -> Dict[str, Any]:
        """The manifest's recorded run meta (world size, plan knobs,
        flat-shard layout), ``{}`` for a manifest written by an older
        version or lost/corrupt — callers degrade (same-world resume
        only), they never KeyError."""
        try:
            with open(self._manifest_path()) as f:
                doc = json.load(f)
            meta = doc.get("meta")
            if isinstance(meta, dict):
                return meta
        except (OSError, ValueError):
            pass
        return {}

    def latest(self) -> Optional[Tuple[int, str]]:
        """Newest (step, path) whose file passes :func:`checkpoint.verify`
        — corrupt/partial/missing candidates are skipped, so a save that
        died mid-write can never be selected for resume."""
        with self._lock:
            rows = self._read_manifest()
        for row in reversed(rows):
            path = os.path.join(self.directory, row["file"])
            try:
                _ckpt.verify(path)
            except (CheckpointError, OSError):
                continue
            return int(row["step"]), path
        return None

    def load_latest(self, *, with_meta: bool = False):
        """Load the newest readable checkpoint: ``(step, payload)``, or
        None when no checkpoint survives verification.  A file that
        passes the CRC probe but fails the full load (shouldn't happen,
        but disks lie) is skipped like any other corrupt candidate.
        ``with_meta=True`` appends the manifest meta as a third element
        (``{}`` for pre-elastic manifests) so resume code sees the
        saved world size / plan / shard layout in the same read."""
        with self._lock:
            rows = self._read_manifest()
        for row in reversed(rows):
            path = os.path.join(self.directory, row["file"])
            try:
                found = int(row["step"]), _ckpt.load(path)
            except (CheckpointError, OSError):
                continue
            if with_meta:
                return found + (self.manifest_meta(),)
            return found
        return None

    def all_steps(self) -> List[int]:
        with self._lock:
            return [r["step"] for r in self._read_manifest()]
