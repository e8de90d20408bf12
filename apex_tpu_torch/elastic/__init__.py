"""apex_tpu_torch.elastic — resume across a change of world size.

Counterpart of ``apex_tpu/elastic``, with its names, events and
guarantees.  A preemptible fleet that grows or shrinks changes the world
size, and a checkpoint written N ways cannot be restored M ways blindly.
Elastic resume combines three pieces the port already has:
:class:`~apex_tpu_torch.resilience.guard.TrainGuard`'s bitwise resume, the
:mod:`~apex_tpu_torch.parallel.plan` cost-model search (re-run whenever the
device pool changes, AMP arXiv:2210.07297) and the canonical-flat
optimizer layout of :mod:`~apex_tpu_torch.parallel.weight_update`
(arXiv:2004.13336):

  1. **detect**: the checkpoint manifest records the world size, the plan
     knobs and the flat-shard layout (``CheckpointManager`` meta); the
     guard compares it with the live world at resume;
  2. **re-plan**: :func:`replan` re-runs ``plan.search`` for the new chip
     count, and :func:`install` hooks ``plan.from_tuning``'s chips
     mismatch so that a stale tuned plan triggers the same search;
  3. **reshard**: :func:`reshard_payload` re-slices the payload.  The
     guard's snapshot under a process group gathers every flat-shard
     field into the canonical flat (``layout["flat_total"]`` long) and
     stacks the per-rank error-feedback residuals into ``(N,
     flat_total)``: the JAX package's payload.  Only the trailing zero
     padding that rounds the ``used`` prefix up to whole shards depends
     on the world, so a reshard is a re-chunk
     (:func:`~apex_tpu_torch.parallel.collectives.rechunk_flat`), bitwise
     on every real element, for the master and moment buffers and the
     int8 residuals (an all-zero pad block quantizes with scale 0, so its
     residual is zero too).  Replicated leaves pass through;
  4. **resume**: each rank takes its slice of the resharded canonical
     payload and the run continues mid-epoch.

Guarantees (``tests/test_torch_elastic.py``): the N -> M -> N round trip
is bitwise for any (N, M), divisible or not, and equals the JAX
package's bit for bit; a world-4 zero1 + int8 run killed by
``resize@6:2`` finishes at world 2 with parameters, moments and residual
bitwise those of a clean world-2 run started from the same checkpoint.
Growing (2 -> 4) holds to fp32 tolerance: the reshard is exact, but the
wider group changes which local gradients each rank quantizes.

Opt-in is explicit: without :func:`install` (or ``TrainGuard(elastic=
...)``) a world-size mismatch at resume raises the typed
:class:`~apex_tpu_torch.resilience.ckpt.WorldSizeMismatchError` naming
both counts.

Usage::

    import apex_tpu_torch.elastic as elastic
    elastic.install()                      # the process-default resharder
    state0, step, layout, shards = train.flagship_guard_step(cfg, ...)
    cfg = GuardConfig(ckpt_dir=..., world_size=dist.get_world_size(),
                      ckpt_meta={"plan": plan.knobs(), "layout": layout})
    TrainGuard(step, cfg, state_shards=shards,
               shard_group=step.weight_update.group).run(state0, batches, n)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..parallel import collectives as _coll
from ..parallel import plan as _plan
from ..resilience.ckpt import (ManifestCompatWarning, WorldSizeMismatchError,
                               META_DATA_KEY, META_LAYOUT_KEY,
                               META_PLAN_KEY, META_WORLD_KEY)
from ..utils.pytree import tree_leaves

__all__ = [
    "ElasticResume", "ManifestCompatWarning", "WorldSizeMismatchError",
    "can_reshard", "install", "installed", "repartition_data", "replan",
    "reshard_payload", "uninstall",
]


def _emit_default(name: str, **fields) -> None:
    """An event through the process-default registry when one is
    installed, else a tracer instant (``TrainGuard._emit``'s rule)."""
    from ..telemetry import events as _events
    reg = _events.get_default()
    if reg is not None and reg.enabled:
        reg.event(name, **fields)
        return
    from ..telemetry import trace as _trace
    _trace.note_event(name, step=fields.get("step"), fields=fields)


def can_reshard(meta: dict) -> bool:
    """Does this manifest meta carry what a reshard needs?  False for a
    manifest written before elastic resume existed: callers degrade to a
    same-world resume (with a :class:`ManifestCompatWarning`)."""
    return bool(
        isinstance(meta, dict)
        and meta.get(META_WORLD_KEY)
        and isinstance(meta.get(META_LAYOUT_KEY), dict)
        and meta[META_LAYOUT_KEY].get("flat_total")
        and meta[META_LAYOUT_KEY].get("used") is not None)


def _stacked_lattice(h, tshape, stacked, saved_world, live_world):
    """A stage / expert row lattice ``(rows, row_total)`` re-chunked into
    the live ``tshape`` lattice: each row's ``row_used`` prefix (its tail
    checked zero), concatenated into one canonical sequence, re-padded at
    the global tail only."""
    hshape = tuple(h.shape)
    ru = stacked.get("row_used", stacked.get("row_total"))
    used_rows = ([int(u) for u in ru] if isinstance(ru, (list, tuple))
                 else [int(ru)] * hshape[0])
    if len(used_rows) != hshape[0]:
        raise WorldSizeMismatchError(
            saved_world, live_world,
            detail=f"stacked.row_used has {len(used_rows)} entries for "
                   f"{hshape[0]} rows")
    rows = np.asarray(h)
    try:
        parts = [_coll.rechunk_flat(rows[i], used=u, total=u)
                 for i, u in enumerate(used_rows)]
        flat = (np.concatenate(parts) if parts
                else np.zeros((0,), rows.dtype))
        return _coll.rechunk_flat(flat, used=int(flat.shape[0]),
                                  total=tshape[0] * tshape[1]
                                  ).reshape(tshape)
    except ValueError as err:
        # content that cannot live in the new lattice is a model change
        raise WorldSizeMismatchError(
            saved_world, live_world,
            detail=f"stage/expert resize {hshape} -> {tshape}: {err}")


def reshard_payload(template_state, payload: dict, saved_meta: dict,
                    live_world: int, *, emit=None) -> dict:
    """Re-slice a guard checkpoint payload written at ``saved_meta``'s
    world size into the ``live_world`` layout of ``template_state``.

    ``payload`` is the guard's snapshot (``{"step": int, "leaves": [host
    arrays]}``, canonical: see the module docstring); its leaves match the
    template's (:func:`~apex_tpu_torch.utils.pytree.tree_leaves`, only
    their shapes are read) by position:

      * a 1-D saved leaf of the saved canonical length
        (``layout.flat_total``) whose template twin is 1-D of another
        length is a **flat-shard field** (master, moments): re-chunked
        (keep the ``used`` prefix, zero-pad to the live total);
      * a 2-D ``(saved_world, flat_total)`` leaf whose twin is
        ``(live_world, live_total)`` is a stack of **per-rank EF
        residuals**.  The pending correction is their sum, so the
        re-chunked rows are summed onto row 0 in order (fp32, the sum
        kept exactly) and the other rows are zero;
      * a 2-D leaf matching the layout's ``stacked`` block (``{"rows": N,
        "row_total": T, "row_used": int | [int, ...]}``, a pipeline-stage
        or expert lattice) whose twin has another row lattice is a
        **stage / expert resize**: the rows' used prefixes concatenate
        into one canonical sequence, re-chunked into the live lattice;
        content that does not fit it raises;
      * every other leaf of equal shape passes through unchanged;
      * any other shape disagreement is a model or configuration change,
        raised as :class:`WorldSizeMismatchError` with detail.

    Emits one ``elastic.reshard`` event (and span) naming both worlds and
    the number of fields re-sliced."""
    from ..telemetry import trace as _trace

    if not can_reshard(saved_meta):
        raise WorldSizeMismatchError(
            saved_meta.get(META_WORLD_KEY) or 0, live_world,
            detail="manifest lacks the flat-shard layout fields")
    layout = saved_meta[META_LAYOUT_KEY]
    saved_world = int(saved_meta[META_WORLD_KEY])
    saved_total = int(layout["flat_total"])
    used = int(layout["used"])
    emit = emit or _emit_default

    tmpl_leaves = tree_leaves(template_state)
    saved = payload["leaves"]
    if len(saved) != len(tmpl_leaves):
        raise WorldSizeMismatchError(
            saved_world, live_world,
            detail=f"checkpoint has {len(saved)} leaves but the live "
                   f"state has {len(tmpl_leaves)} — the model/optimizer "
                   "configuration changed, not just the world size")

    t0 = time.perf_counter()
    resharded = 0
    out = []
    with _trace.span("elastic.reshard", step=payload.get("step"),
                     from_world=saved_world, to_world=live_world):
        for t, h in zip(tmpl_leaves, saved):
            tshape = tuple(getattr(t, "shape", ()) or ())
            hshape = tuple(getattr(h, "shape", ()) or ())
            if tshape == hshape or not hasattr(h, "dtype"):
                out.append(h)
                continue
            if (len(hshape) == 1 and len(tshape) == 1
                    and hshape[0] == saved_total):
                out.append(_coll.rechunk_flat(h, used=used,
                                              total=tshape[0]))
                resharded += 1
                continue
            stacked = layout.get("stacked")
            if (isinstance(stacked, dict) and len(hshape) == 2
                    and len(tshape) == 2
                    and hshape == (int(stacked.get("rows") or -1),
                                   int(stacked.get("row_total") or -1))):
                out.append(_stacked_lattice(h, tshape, stacked,
                                            saved_world, live_world))
                resharded += 1
                continue
            if (len(hshape) == 2 and len(tshape) == 2
                    and hshape == (saved_world, saved_total)
                    and tshape[0] == live_world):
                acc = np.zeros((tshape[1],), np.asarray(h).dtype)
                for row in np.asarray(h):
                    acc = acc + _coll.rechunk_flat(row, used=used,
                                                   total=tshape[1])
                stack = np.zeros(tshape, acc.dtype)
                stack[0] = acc
                out.append(stack)
                resharded += 1
                continue
            raise WorldSizeMismatchError(
                saved_world, live_world,
                detail=f"leaf shape {hshape} cannot be resharded into "
                       f"{tshape} (not a canonical flat field of length "
                       f"{saved_total})")
    emit("elastic.reshard", step=payload.get("step"),
         from_world=saved_world, to_world=live_world,
         fields_resharded=resharded, flat_total_saved=saved_total,
         used=used, seconds=time.perf_counter() - t0)
    return {**payload, "leaves": out}


def repartition_data(saved_meta: dict, live_world: int, *,
                     emit=None) -> Optional[dict]:
    """Re-partition the data plane's shard assignment for a resume at a
    new ingest world: the data half of the optimizer reshard.

    The seekable data plane (``data.sharded``) makes this deterministic:
    the global batch of a step depends only on ``(seed, epoch, step)``,
    never on the host count, so an N -> M re-assignment re-slices the
    same record stream.  What is left is validation and the audit event:
    the saved ``meta["data"]`` block must exist (else None: nothing to
    re-partition) and its ``global_batch`` must divide over
    ``live_world`` (else :class:`WorldSizeMismatchError`: a batch that
    cannot split M ways is a configuration change, not a resize).

    Emits one ``elastic.data_repartition`` event and returns the new
    assignment (``from_world`` / ``to_world`` / ``global_batch`` /
    ``records_per_host`` / ``index_digest`` / ``cursor``)."""
    data = saved_meta.get(META_DATA_KEY) if isinstance(saved_meta, dict) \
        else None
    if not isinstance(data, dict) or not data.get("global_batch"):
        return None
    emit = emit or _emit_default
    gb = int(data["global_batch"])
    from_world = int(data.get("world") or 1)
    live_world = int(live_world)
    if live_world < 1 or gb % live_world:
        raise WorldSizeMismatchError(
            saved_meta.get(META_WORLD_KEY) or from_world, live_world,
            detail=f"data-plane global_batch {gb} cannot be "
                   f"re-partitioned over {live_world} ingest hosts")
    cursor = data.get("cursor") if isinstance(data.get("cursor"), dict) \
        else {}
    out = {"from_world": from_world, "to_world": live_world,
           "global_batch": gb, "records_per_host": gb // live_world,
           "index_digest": data.get("index_digest"),
           "cursor": cursor}
    emit("elastic.data_repartition", step=cursor.get("step"),
         from_world=from_world, to_world=live_world, global_batch=gb,
         records_per_host=gb // live_world,
         index_digest=data.get("index_digest"))
    return out


def replan(chips: int, *, profile=None, saved_knobs: Optional[dict] = None,
           emit=None, **search_kw) -> Optional[_plan.Plan]:
    """Re-run the cost-model search for a new chip count.  ``profile`` is
    a :class:`~apex_tpu_torch.parallel.plan.ModelProfile`; None profiles
    the flagship step on the card (an executed step: pass a profile on
    hot paths).  Returns the ranked winner (None when no plan is
    feasible) and emits one ``elastic.replan`` event with the old knobs
    (when known) and the winner's.

    Callers: the elastic resume (the pool changed across a restart) and
    the run controller's ``replan_reshard`` actuator (the pool is the same
    but the measured goodput regime changed); both run inside the
    ``elastic.replan`` span, which the goodput ledger meters as
    ``reshard`` badput."""
    from ..telemetry import trace as _trace
    emit = emit or _emit_default
    if profile is None:
        profile, _, _ = _plan.flagship_profile()
    t0 = time.perf_counter()
    with _trace.span("elastic.replan", chips=int(chips)):
        ranked = _plan.search(profile, int(chips), **search_kw)
    winner = ranked[0] if ranked else None
    emit("elastic.replan", chips=int(chips),
         candidates=len(ranked),
         old_knobs=dict(saved_knobs) if saved_knobs else None,
         new_knobs=winner.knobs() if winner is not None else None,
         predicted_step_ms=(winner.predicted_step_ms
                            if winner is not None else None),
         seconds=time.perf_counter() - t0)
    return winner


@dataclasses.dataclass
class ElasticResume:
    """The guard-facing resharder: what ``TrainGuard(elastic=...)``, or
    the process default :func:`install` registers, calls when a resume
    crosses a change of world size.

    ``profile`` (a :class:`~apex_tpu_torch.parallel.plan.ModelProfile`)
    enables the re-plan: ``plan.search`` re-runs for the live chip count
    and the winner lands in ``last_plan`` and the ``elastic.replan``
    event.  Without one only the reshard runs (profiling inside a resume
    would hide an executed step in the recovery path).  ``search_kw``
    goes to ``plan.search``."""
    profile: object = None
    search_kw: dict = dataclasses.field(default_factory=dict)
    last_plan: Optional[_plan.Plan] = None
    #: the data-plane re-partition of the last resume (None when the
    #: manifest carried no data block)
    last_data: Optional[dict] = None

    def resume(self, template_state, payload: dict, saved_meta: dict,
               live_world: int, *, emit=None) -> dict:
        out = reshard_payload(template_state, payload, saved_meta,
                              live_world, emit=emit)
        self.last_data = repartition_data(saved_meta, live_world,
                                          emit=emit)
        if self.profile is not None:
            self.last_plan = replan(
                live_world, profile=self.profile,
                saved_knobs=saved_meta.get(META_PLAN_KEY), emit=emit,
                **self.search_kw)
        return out


def install(profile=None, **search_kw) -> ElasticResume:
    """Make the process elastic: register an :class:`ElasticResume` as
    the guard's default resharder and hook ``plan.from_tuning``'s chips
    mismatch into :func:`replan`.  Returns the installed object;
    :func:`uninstall` reverses both."""
    from ..resilience import guard as _guard
    er = ElasticResume(profile=profile, search_kw=dict(search_kw))
    _guard.set_resharder(er)
    _plan.set_replan_hook(
        lambda tuned, chips: replan(chips, profile=er.profile,
                                    saved_knobs=tuned.knobs(),
                                    **er.search_kw))
    return er


def uninstall() -> None:
    """Remove the process-default resharder and the re-plan hook."""
    from ..resilience import guard as _guard
    _guard.set_resharder(None)
    _plan.set_replan_hook(None)


def installed() -> Optional[ElasticResume]:
    """The process-default resharder, if :func:`install` ran."""
    from ..resilience import guard as _guard
    return _guard.get_resharder()
