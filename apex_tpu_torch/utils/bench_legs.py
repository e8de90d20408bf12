"""Incremental bench-leg persistence: a bench that dies part-way keeps
the legs it finished.

Counterpart of ``apex_tpu/utils/bench_legs.py``, with ``"gpu"`` in the
place of the JAX package's ``"tpu"`` backend tag (and so
:func:`read_gpu_legs` for ``read_tpu_legs``, and ``kernel_microbench`` for
the kernels payload's ``pallas_kernel_microbench``).  Each bench leg flushes
its JSON to a legs directory the moment it completes (a temporary file
renamed into place, so a kill mid-write never leaves a corrupt file), and
:func:`assemble` rebuilds a payload from whatever legs landed.

Leg file format (one JSON object per file, ``<name>.json``)::

    {"leg": name, "ts": "2026-07-30T22:41:07Z", "backend": "gpu",
     "data": {...}}

A leg's ``backend`` defaults to ``"gpu"`` when torch sees a CUDA card,
else ``"cpu"``.  A CPU record never overwrites or merges into a GPU one.

CLI::

    python -m apex_tpu_torch.utils.bench_legs <legs_dir> [--kind bench|kernels]

prints the assembled one-line JSON on stdout.  Nothing in the port's
benchmark reads it yet.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional


def _deep_merge(old: dict, new: dict) -> dict:
    """New values win; dict-vs-dict merges recursively (keeps a previous
    window's sweep rows when the re-run re-measured only some of them)."""
    out = dict(old)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _scrub_keys(data: Any, keys) -> Any:
    """Recursively drop ``keys`` from nested dicts (returns a copy)."""
    if not isinstance(data, dict):
        return data
    return {k: _scrub_keys(v, keys) for k, v in data.items()
            if k not in keys}


def _default_backend() -> str:
    """"gpu" when torch sees a CUDA card, else "cpu"."""
    import torch
    return "gpu" if torch.cuda.is_available() else "cpu"


def flush_leg(legs_dir: Optional[str], name: str, data: Any,
              backend: Optional[str] = None, merge: bool = False,
              drop: tuple = ()) -> None:
    """Atomically write ``<legs_dir>/<name>.json``.  No-op when
    ``legs_dir`` is falsy.  Re-flushing the same name overwrites: legs
    that accrete results (the headline A/B) flush after every
    sub-measurement, so a leg cut in the middle keeps its finished parts.

    ``merge=True``: dict data is deep-merged over the leg file's
    existing dict data (new keys win leaf-wise; nested dicts, sweep rows
    like ``by_seq``, merge recursively) instead of replacing it, so a
    re-run cut earlier than a previous one cannot destroy the previous
    run's measurements.  Merging applies only when both old and new data
    are dicts and the old record's backend matches (a CPU leg never
    leaks values into a GPU leg).

    ``drop``: key names scrubbed (recursively) from the final record, how
    renamed or retired fields leave merged artifacts (a deep merge alone
    would keep an old key beside its new name forever)."""
    if not legs_dir:
        return
    os.makedirs(legs_dir, exist_ok=True)
    if backend is None:
        backend = _default_backend()
    old = read_legs(legs_dir).get(name)
    if (old is not None and old.get("backend") == "gpu"
            and backend != "gpu"):
        # never downgrade: a CPU re-run into the same legs dir must not
        # destroy a GPU measurement already captured there
        return
    if merge and isinstance(data, dict):
        if (old is not None and old.get("backend") == backend
                and isinstance(old.get("data"), dict)):
            data = _deep_merge(old["data"], data)
    if drop:
        data = _scrub_keys(data, frozenset(drop))
    rec = {"leg": name,
           "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "backend": backend,
           "data": data}
    tmp = os.path.join(legs_dir, f".{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, os.path.join(legs_dir, f"{name}.json"))


def make_flusher(legs_dir: Optional[str],
                 drop: tuple = ()) -> Callable[..., None]:
    """Bind ``legs_dir`` (and retired key names to scrub) once; benches
    call ``flush(name, data)``."""
    def flush(name: str, data: Any, merge: bool = False) -> None:
        flush_leg(legs_dir, name, data, merge=merge, drop=drop)
    return flush


def argval(argv, flag):
    """Value of ``--flag VALUE`` in argv, else None (shared by the two
    bench scripts' hand-rolled CLIs)."""
    if flag in argv:
        i = argv.index(flag)
        if i + 1 < len(argv):
            return argv[i + 1]
    return None


def read_gpu_legs(legs_dir: Optional[str]) -> Dict[str, dict]:
    """GPU-backend legs only (the JAX package's ``read_tpu_legs``): what a
    payload run on the CPU may surface as partial GPU legs."""
    if not legs_dir:
        return {}
    return {n: r for n, r in read_legs(legs_dir).items()
            if r.get("backend") == "gpu"}


def read_legs(legs_dir: str) -> Dict[str, dict]:
    """All parseable leg records in ``legs_dir``, keyed by leg name.
    Unparseable files (shouldn't exist, given atomic writes) are
    skipped, not fatal."""
    out: Dict[str, dict] = {}
    if not legs_dir or not os.path.isdir(legs_dir):
        return out
    for fn in sorted(os.listdir(legs_dir)):
        if not fn.endswith(".json") or fn.startswith("."):
            continue
        try:
            with open(os.path.join(legs_dir, fn)) as f:
                rec = json.load(f)
            out[rec.get("leg", fn[:-5])] = rec
        except (OSError, ValueError):
            continue
    return out


def assemble(legs_dir: str, kind: str = "bench") -> dict:
    """Rebuild a driver-shaped payload from the legs that landed.

    ``kind="bench"`` gives the JAX ``bench.py`` payload's shape (the
    headline metric and detail legs); ``kind="kernels"`` the JAX
    ``bench_kernels.py`` one's, under the metric ``kernel_microbench``.
    The result always carries ``"partial": true`` and the per-leg
    timestamps: an assembled payload documents an interrupted run, it
    never passes for a complete one.
    """
    legs = read_legs(legs_dir)
    ts = {name: rec.get("ts") for name, rec in legs.items()}
    backends = {rec.get("backend") for rec in legs.values()}
    # "none" (not "mixed") for an empty dir: nothing was measured on any
    # backend, and "mixed" reads as partly measured on the card
    backend = (backends.pop() if len(backends) == 1
               else "mixed" if backends else "none")

    def tag(rec, data):
        """With mixed backends, every merged value says which backend
        produced it: a CPU ms beside a GPU ms with no label would pass
        for a card measurement."""
        if backend != "mixed":
            return data
        if isinstance(data, dict):
            return {"_backend": rec.get("backend"), **data}
        return {"_backend": rec.get("backend"), "value": data}

    if kind == "kernels":
        kernels: Dict[str, Any] = {}
        for name, rec in legs.items():
            data = rec.get("data")
            if isinstance(data, dict):
                for k, v in data.items():
                    kernels[k] = tag(rec, v)
            else:
                kernels[name] = tag(rec, data)
        return {"metric": "kernel_microbench", "backend": backend,
                "compiled": backend == "gpu", "kernels": kernels,
                "partial": True, "leg_timestamps": ts}

    detail: Dict[str, Any] = {}
    value = None
    vs_baseline = None
    head_rec = legs.get("headline", {})
    head = head_rec.get("data")
    if isinstance(head, dict):
        detail.update(tag(head_rec, head))
        # the headline metric only surfaces from a GPU-backend headline
        # leg (or a uniform run, where the top-level `backend` labels it)
        if backend != "mixed" or head_rec.get("backend") == "gpu":
            # best against best across dtype-matched pairs (fp32 impls
            # against the fp32 baseline; flat-bf16 against the bf16 one).
            # A pair missing its baseline must not win `value` and drop
            # vs_baseline when a full pair exists: the best full pair
            # first, the best baseline-less impl only when no pair
            # completed.
            base = head.get("optax_baseline_ms")
            pairs = [(head.get("xla_impl_ms"), base),
                     (head.get("fused_flat_impl_ms"), base),
                     (head.get("fused_flat_bf16grads_ms"),
                      head.get("optax_bf16grads_ms")),
                     (head.get("fused_flat_bf16state_ms"),
                      head.get("optax_bf16grads_ms"))]
            done = [(m, b) for m, b in pairs
                    if isinstance(m, (int, float))]
            full = [(m, b) for m, b in done
                    if isinstance(b, (int, float))]
            if full:
                value, vbase = min(full, key=lambda p: p[0])
                if head_rec.get("backend") == "gpu":
                    vs_baseline = round(vbase / value, 3)
            elif done:
                value = min(m for m, _ in done)
    for name, rec in legs.items():
        if name != "headline":
            detail[name] = tag(rec, rec.get("data"))
    return {"metric": "fused_lamb_step_ms_bert_large", "value": value,
            "unit": "ms", "vs_baseline": vs_baseline, "backend": backend,
            "partial": True, "leg_timestamps": ts, "detail": detail}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("legs_dir")
    ap.add_argument("--kind", choices=("bench", "kernels"), default="bench")
    args = ap.parse_args(argv)
    print(json.dumps(assemble(args.legs_dir, args.kind)))


if __name__ == "__main__":
    main()
