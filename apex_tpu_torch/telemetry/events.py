"""Structured events wired into the port's hook points.

Counterpart of the JAX package's ``apex_tpu/telemetry/events.py``, with
its public names and record names:

  * **amp scaler** -- transitions are observed host-side by comparing the
    pre/post ``ScalerState`` (one host read of its four scalars, stacked
    on their device): :func:`observe_scaler` / :func:`observe_amp`
    classify halve (overflow), double (scale_window growth) and steady
    steps via ``amp.scaler.transition_kind`` and emit ``amp.overflow`` /
    ``amp.loss_scale_doubled`` events plus the ``amp.loss_scale`` gauge.
  * **collectives** -- :func:`record_collective` takes the payload bytes,
    leaf count and host wall time of a reduction (no caller in the port
    yet: the DDP and ZeRO meters come with the port of
    ``parallel.overlap`` / ``weight_update``).
  * **data** -- the loader reports the consumer wait and queue depth
    (:func:`record_loader`) and its bounded retries
    (:func:`record_loader_retry`); ``data.sharded`` a failed shard
    checksum (:func:`record_shard_checksum`).
  * **checkpoints** -- :func:`record_ckpt` / :func:`record_ckpt_exposed`.

All hooks route through the process-default registry
(:func:`set_default`); with none installed every hook is a single
attribute check and an early return.  Divergence:
:func:`install_compile_listener` returns False, since the port compiles
nothing at run time (its kernels build once, before any step) and so
emits no ``compile.*`` spans.
"""
from __future__ import annotations

from typing import Optional

from . import registry as _registry
from . import trace as _trace


# -- default-registry plumbing (lives here so the hooks avoid importing
#    the package __init__ back into themselves) -----------------------------

_default: Optional[_registry.Registry] = None


def set_default(reg: Optional[_registry.Registry]):
    """Install ``reg`` as the process-default registry the library hooks
    (loader, shards, serving) report into.  Pass None to uninstall.  Returns the
    previous default so callers can restore it."""
    global _default
    prev = _default
    _default = reg
    return prev


def get_default() -> Optional[_registry.Registry]:
    return _default


def active() -> bool:
    """True when a default registry is installed and enabled — the fast
    guard every library hook checks first."""
    return _default is not None and _default.enabled


def metering() -> bool:
    """True when EITHER a default registry or a default tracer is
    installed — instrumented library code (the DDP collective meter)
    measures when anything downstream will consume it, and stays free
    otherwise."""
    return active() or _trace.active()


# -- amp scaler transitions --------------------------------------------------

def observe_scaler(reg, prev, new, *, loss_id: int = 0) -> Optional[str]:
    """Classify one scaler update (host-side, after the step) and emit the
    matching event/metrics into ``reg``.

    ``prev``/``new`` are the ``ScalerState`` before/after ``amp_step``
    (or ``scaler.update``).  One host read takes the four scalars,
    stacked on their device -- gated on the registry being enabled, so
    an instrumented loop with telemetry off pays no device read here.
    Returns the transition kind ("overflow" | "grew" | "steady"), or
    None when disabled (nothing was read).
    """
    if reg is None or not reg.enabled:
        return None
    import torch
    from ..amp import scaler as _scaler
    with _trace.span("amp.observe_scaler", loss_id=loss_id):
        ps, ns, pu, nu = torch.stack([
            torch.as_tensor(v).detach().reshape(()).to(torch.float64)
            for v in (prev.loss_scale, new.loss_scale, prev.unskipped,
                      new.unskipped)]).cpu().tolist()
    kind = _scaler.transition_kind(ps, ns, pu, nu,
                                   scale_window=prev.scale_window,
                                   min_loss_scale=prev.min_loss_scale,
                                   max_loss_scale=prev.max_loss_scale)
    reg.gauge("amp.loss_scale").set(ns)
    if kind == "overflow":
        reg.counter("amp.overflow_steps").add(1)
        reg.event("amp.overflow", loss_id=loss_id,
                  old_scale=ps, new_scale=ns)
    elif kind == "grew":
        reg.event("amp.loss_scale_doubled", loss_id=loss_id,
                  old_scale=ps, new_scale=ns, after_steps=int(pu) + 1)
    return kind


def observe_amp(reg, prev_state, new_state):
    """Per-loss :func:`observe_scaler` over two ``AmpState`` bundles
    (the host-side companion to ``amp.amp_step``).  Returns
    the list of transition kinds, one per scaler."""
    return [observe_scaler(reg, p, n, loss_id=i)
            for i, (p, n) in enumerate(zip(prev_state.scalers,
                                           new_state.scalers))]


# -- library hooks (no-ops without a default registry) -----------------------

def record_collective(axis_name: str, nbytes: int, n_leaves: int,
                      seconds: float, *, wire_bytes=None, dtype=None,
                      scheme=None, op: str = "allreduce",
                      family: Optional[str] = None) -> None:
    """Collective meter: bytes reduced + wall time per all-reduce
    (``op="allreduce"``), per ZeRO collective (``op="reduce_scatter"`` /
    ``"allgather"``), and per weight-update-sharding collective
    (``op="reduce_scatter"`` / ``"param_allgather"`` with
    ``family="ddp"``).  ``family`` prefixes the metric names; it
    defaults to ``"ddp"`` for the allreduce and ``"zero"`` otherwise,
    the JAX package's names.

    Compression accounting: ``nbytes`` is the
    LOGICAL payload (what an uncompressed reduction would move);
    ``wire_bytes`` is what the selected collective scheme actually
    ships (defaults to ``nbytes`` — uncompressed).  ``dtype`` labels
    the wire payload ("int8", "bfloat16", ... or "mixed"), ``scheme``
    names the collective scheme.  Counters:
    ``<family>.<op>_compressed_bytes`` accumulates the wire bytes and
    the ``<family>.<op>_compression_ratio`` gauge carries the per-call
    logical/wire ratio, so a run's compression win is provable from the
    JSONL alone."""
    wire = int(nbytes if wire_bytes is None else wire_bytes)
    if family is None:
        family = "ddp" if op == "allreduce" else "zero"
    name = f"{family}.{op}"
    extra = {}
    if dtype is not None:
        extra["dtype"] = str(dtype)
    if scheme is not None:
        extra["scheme"] = str(scheme)
    _trace.note_span(name, seconds, axis=axis_name,
                     bytes=int(nbytes), leaves=int(n_leaves),
                     wire_bytes=wire, **extra)
    if not active():
        return
    reg = _default
    reg.counter(f"{name}_calls").add(1)
    reg.counter(f"{name}_bytes").add(nbytes)
    reg.counter(f"{name}_compressed_bytes").add(wire)
    if op == "allreduce":
        reg.counter("ddp.allreduce_leaves").add(n_leaves)
    if wire:
        reg.gauge(f"{name}_compression_ratio").set(nbytes / wire)
    reg.histogram(f"{name}_host_ms").observe(seconds * 1e3)
    reg.event(name, axis=axis_name, bytes=int(nbytes),
              leaves=int(n_leaves), host_ms=seconds * 1e3,
              wire_bytes=wire, **extra)


def record_loader(depth: Optional[int], wait_seconds: float) -> None:
    """Loader meter: consumer wait per batch, ring/queue depth after the
    dequeue (None when the native ring can't report it)."""
    _trace.note_span("loader.wait", wait_seconds,
                     **({} if depth is None else {"depth": depth}))
    if not active():
        return
    reg = _default
    reg.histogram("loader.wait_ms").observe(wait_seconds * 1e3)
    if depth is not None:
        reg.gauge("loader.queue_depth").set(depth)
        reg.histogram("loader.depth_samples").observe(depth)


def record_loader_retry(batch_index: int, attempt: int, waited_s: float,
                        next_wait_s: float) -> None:
    """One bounded-retry attempt inside the loader's timed wait: the
    consumer saw an empty queue for
    a full wait window and is waiting again with a doubled budget
    instead of escalating yet.  ``loader.retry`` event + ``loader.
    retries`` counter; retries exhausted still raise the typed
    ``LoaderStallError``, so the event stream tells a healed hiccup
    from a real wedge."""
    _trace.note_event("loader.retry", step=int(batch_index),
                      fields={"attempt": int(attempt),
                              "waited_ms": waited_s * 1e3,
                              "next_wait_ms": next_wait_s * 1e3})
    if not active():
        return
    reg = _default
    reg.counter("loader.retries").add(1)
    reg.event("loader.retry", batch=int(batch_index), attempt=int(attempt),
              waited_ms=waited_s * 1e3, next_wait_ms=next_wait_s * 1e3)


def record_shard_checksum(shard: str, offset=None) -> None:
    """A shard failed its CRC32 check (``data.sharded`` — bit rot or an
    injected ``shard_corrupt`` fault): ``data.checksum_failed`` event +
    counter, emitted just before the typed ``ShardChecksumError``
    propagates so the failure is visible in the JSONL even when the
    run dies on it.  ``offset`` is the record offset within the shard
    the failing read wanted (None for a whole-shard verify sweep)."""
    fields = {"shard": str(shard)}
    if offset is not None:
        fields["offset"] = int(offset)
    _trace.note_event("data.checksum_failed", fields=fields)
    if not active():
        return
    reg = _default
    reg.counter("data.checksum_failures").add(1)
    reg.event("data.checksum_failed", **fields)


def record_update_sharding(state_bytes_per_replica: int,
                           world: int) -> None:
    """Weight-update-sharding gauges: optimizer-state bytes actually held
    per replica under the current sharding, and the shard count (one
    attribute check with no registry installed)."""
    if not active():
        return
    reg = _default
    reg.gauge("ddp.opt_state_bytes_per_replica").set(
        float(state_bytes_per_replica))
    reg.gauge("ddp.update_shard_world").set(float(world))


def record_ckpt_exposed(seconds: float, reg=None, step=None) -> None:
    """Boundary-blocked checkpoint time (the goodput ledger's
    ``ckpt_exposed``): the wall-clock the STEP LOOP actually waited on checkpoint
    machinery — writer drains/submits and the inline anchor/exit saves
    — as opposed to :func:`record_ckpt`'s ``ckpt.write_ms``, which is
    the background writer's own (overlapped) duration.  ``ckpt.
    exposed_ms`` gauge carries the last blocking occurrence and the
    ``ckpt.exposed_ms_total`` counter accumulates the run total, so a
    fully-overlapped background save provably contributes ~0."""
    if reg is None:
        reg = _default
    if reg is None or not reg.enabled:
        return
    reg.gauge("ckpt.exposed_ms").set(seconds * 1e3)
    reg.counter("ckpt.exposed_ms_total").add(seconds * 1e3)


def record_ckpt(seconds: float, nbytes: int, reg=None) -> None:
    """Checkpoint-write meter, called from the guard's BACKGROUND
    writer thread after each ``CheckpointManager.save``: write duration
    and bytes-written gauges (gauge set is a single atomic assignment,
    so the off-thread emit never races the main thread's flush).
    ``reg`` pins a registry (a guard constructed with ``registry=...``
    must meter into IT, like every other guard emission); default: the
    process default."""
    if reg is None:
        reg = _default
    if reg is None or not reg.enabled:
        return
    reg.gauge("ckpt.write_ms").set(seconds * 1e3)
    reg.gauge("ckpt.bytes_written").set(float(nbytes))


# -- compilation meter ---------------------------------------------------------

def install_compile_listener() -> bool:
    """The JAX package registers a ``jax.monitoring`` listener that turns
    compile phases into ``compile.*`` spans (``recompile`` badput).  The
    port compiles nothing while a run steps, so there is nothing to
    listen to: returns False, the JAX function's answer where no listener
    is active."""
    return False
