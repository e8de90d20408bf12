"""Continuous-batching scheduler: admission queue, prefill/decode
interleaving at a fixed decode width, mid-flight eviction with page
recycling, typed load shedding.

Counterpart of ``apex_tpu/serve/schedule.py``.  Each scheduler step (a)
fires any scheduled ``request_flood`` chaos (:mod:`..resilience.faults`),
(b) admits queued requests into free decode slots — allocating their
prompt pages and running prefill one request at a time, (c) grows each
active slot's page table when its context crosses a page boundary — pool
exhaustion here (or at admission) sheds the request via the typed
:class:`~apex_tpu_torch.serve.cache.KVCacheExhaustedError` path instead of
running the device out of memory, with its pages recycled and the shed time
metered, (d) runs ONE batched decode step over all active slots, and (e)
performs the step's single batched device-to-host read.

Host-read discipline: device values cross to the host in EXACTLY ONE
copy per scheduler step — the decode batch's sampled tokens plus any
freshly prefilled first tokens, concatenated on the device and read
together at the step boundary (``host_reads`` counts them).  Every
page-table and position update is host arithmetic that needs no sync.

Every request's life is metered in the per-request latency ledger
(:mod:`apex_tpu_torch.telemetry.serve_ledger`): ``queue`` from submit to
admission, ``prefill`` to its first boundary, ``decode`` per step, and a
``shed`` tail when load shedding ends it early.  With a ``tracer``, spans
wrap each prefill (``serve.prefill``) and each decode step
(``serve.decode``); with a ``registry``, submissions, admissions,
finishes and sheds emit ``serve.*`` events and every step refreshes the
ledger's ``serve.*`` gauges (host floats, read at the registry's next
flush); the live OpenMetrics export starts at construction when
``APEX_TPU_METRICS_PORT`` is set.

Determinism: sampling generators are seeded by ``(request.seed,
position)`` and every engine op is row-independent across slots, so a
request's output does not depend on which slot it holds or who shares the
batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..resilience import faults as _faults
from ..telemetry import export as _export
from ..telemetry.serve_ledger import ServeLedger
from .cache import KVCacheExhaustedError, PagePool

__all__ = ["Request", "ServedResult", "ContinuousBatcher"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request.  ``temperature == 0`` = greedy;
    ``seed`` drives the per-request sampling generator (deterministic
    replay); ``eos_id`` stops generation early when sampled."""
    rid: str
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None


@dataclasses.dataclass
class ServedResult:
    rid: str
    status: str                  # "done" | "shed"
    tokens: List[int]            # generated tokens (incl. eos if hit)
    prompt_len: int
    reason: Optional[str] = None


class _Slot:
    __slots__ = ("req", "pages", "pos", "cur_token", "generated",
                 "pending_first")

    def __init__(self, req, pages):
        self.req = req
        self.pages = pages            # allocated pool pages, in order
        self.pos = len(req.prompt)    # position of the next consumed token
        self.cur_token = None         # host int once the boundary read it
        self.generated: List[int] = []
        self.pending_first = None     # device first token from prefill


class ContinuousBatcher:
    """Drives an :class:`~apex_tpu_torch.serve.engine.InferenceEngine`."""

    def __init__(self, engine, *, ledger: Optional[ServeLedger] = None,
                 registry=None, tracer=None):
        self.engine = engine
        self.cache = engine.cache
        self.pool = PagePool(self.cache)
        self.ledger = ledger if ledger is not None else ServeLedger()
        self.registry = registry
        self.tracer = tracer
        # live export: a serving process arms the endpoint itself (a
        # no-op unless APEX_TPU_METRICS_PORT is set)
        _export.maybe_start(run_id=getattr(registry, "run_id", None))
        self.queue: List[Request] = []
        self.slots: List[Optional[_Slot]] = [None] * engine.decode_width
        self.results: Dict[str, ServedResult] = {}
        self.host_reads = 0
        self._step_idx = 0
        self._flood_seq = 0

    # -- bookkeeping helpers -------------------------------------------------
    def _event(self, name: str, **fields) -> None:
        if self.registry is not None and getattr(self.registry, "enabled",
                                                 False):
            self.registry.event(name, **fields)

    def _span(self, name: str, **attrs):
        if self.tracer is not None:
            return self.tracer.span(name, **attrs)
        return contextlib.nullcontext()

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.ledger.submit(req.rid, prompt_len=len(req.prompt))
        self._event("serve.submit", rid=req.rid)

    def _shed(self, req: Request, reason: str,
              pages: Optional[List[int]] = None) -> None:
        """Typed load shedding: recycle any pages, meter the shed tail,
        record the result — the request ends, the engine does not."""
        if pages:
            self.pool.free(pages)
        self.ledger.finish(req.rid, status="shed")
        self.results[req.rid] = ServedResult(
            req.rid, "shed", [], len(req.prompt), reason=reason)
        self._event("serve.shed", rid=req.rid, reason=reason)

    def _finish(self, slot: _Slot, w: int) -> None:
        self.pool.free(slot.pages)
        self.slots[w] = None
        self.ledger.finish(slot.req.rid, status="done")
        self.results[slot.req.rid] = ServedResult(
            slot.req.rid, "done", list(slot.generated),
            len(slot.req.prompt))
        self._event("serve.finish", rid=slot.req.rid,
                    tokens=len(slot.generated))

    def _slot_done(self, slot: _Slot, token: int) -> bool:
        if slot.req.eos_id is not None and token == slot.req.eos_id:
            return True
        if len(slot.generated) >= slot.req.max_new_tokens:
            return True
        # context window full: the next token has nowhere to live
        return slot.pos + 1 >= self.cache.max_ctx

    def _read(self, dec_out, pending) -> List[int]:
        """THE step's one device-to-host copy: decode tokens followed by
        the admitted requests' first tokens."""
        parts = ([dec_out.reshape(-1)] if dec_out is not None else []) \
            + [p.reshape(1) for p in pending]
        self.host_reads += 1
        return torch.cat(parts).cpu().tolist()

    # -- the chaos hook ------------------------------------------------------
    def _maybe_flood(self) -> None:
        """A scheduled ``request_flood:K`` fault at this step submits K
        short requests at once (``flood-<n>``), as the JAX scheduler
        does."""
        plan = _faults.active_plan()
        spec = plan.fire("request_flood", self._step_idx) if plan else None
        if spec is None:
            return
        k = int(spec.arg)
        for _ in range(k):
            self._flood_seq += 1
            rid = f"flood-{self._flood_seq}"
            self.submit(Request(
                rid=rid, prompt=[1] * min(4, self.cache.max_ctx - 1),
                max_new_tokens=4, seed=1000 + self._flood_seq))
        self._event("serve.request_flood", step=self._step_idx, count=k)
        if self.tracer is not None:
            self.tracer.instant("serve.request_flood",
                                step=self._step_idx, count=k)

    # -- one scheduler step --------------------------------------------------
    def step(self) -> None:
        self._maybe_flood()
        admitted: List[int] = []

        # admission: queued requests into free slots, one prefill each
        free = [w for w, s in enumerate(self.slots) if s is None]
        while self.queue and free:
            req = self.queue.pop(0)
            plen = len(req.prompt)
            if not 0 < plen < self.cache.max_ctx:
                self._shed(req, "prompt_too_long")
                continue
            try:
                pages = self.pool.alloc(self.cache.pages_for(plen))
            except KVCacheExhaustedError:
                self._shed(req, "kv_cache_exhausted")
                continue
            w = free.pop(0)
            slot = _Slot(req, pages)
            self.slots[w] = slot
            self.ledger.phase(req.rid, "prefill")
            table = np.zeros(self.cache.pages_per_request, np.int64)
            table[:len(pages)] = pages
            tokens = np.zeros(self.cache.max_ctx, np.int64)
            tokens[:plen] = req.prompt
            with self._span("serve.prefill", rid=req.rid, prompt_len=plen):
                first, _ = self.engine.prefill(tokens, plen, table, req.seed,
                                               req.temperature, req.top_k)
            slot.pending_first = first
            admitted.append(w)
            self._event("serve.admit", rid=req.rid)

        # page growth + the batched decode step over established slots
        decoding: List[int] = []
        for w, slot in enumerate(self.slots):
            if slot is None or w in admitted or slot.cur_token is None:
                continue
            need = self.cache.pages_for(slot.pos + 1)
            if need > len(slot.pages):
                try:
                    slot.pages += self.pool.alloc(need - len(slot.pages))
                except KVCacheExhaustedError:
                    req, pages = slot.req, slot.pages
                    self.slots[w] = None
                    self._shed(req, "kv_cache_exhausted", pages=pages)
                    continue
            decoding.append(w)

        dec_out = None
        if decoding:
            W = self.engine.decode_width
            PPR = self.cache.pages_per_request
            toks = np.zeros(W, np.int64)
            positions = np.zeros(W, np.int64)
            tables = np.zeros((W, PPR), np.int64)
            seeds = np.zeros(W, np.int64)
            temps = np.zeros(W, np.float32)
            topks = np.zeros(W, np.int64)
            for w in decoding:
                s = self.slots[w]
                toks[w] = s.cur_token
                positions[w] = s.pos
                tables[w, :len(s.pages)] = s.pages
                seeds[w] = s.req.seed
                temps[w] = s.req.temperature
                topks[w] = s.req.top_k
            with self._span("serve.decode", step=self._step_idx,
                            active=len(decoding)):
                dec_out, _ = self.engine.decode_step(
                    toks, positions, tables, seeds, temps, topks)

        # THE step's one batched host read: decode tokens + first tokens
        pending = [self.slots[w].pending_first for w in admitted]
        if dec_out is not None or pending:
            host = self._read(dec_out, pending)
            n_dec = len(host) - len(pending)
            dec_host, first_host = host[:n_dec], host[n_dec:]
            for w in decoding:
                s = self.slots[w]
                tok = int(dec_host[w])
                s.generated.append(tok)
                s.cur_token = tok
                s.pos += 1
                self.ledger.note_tokens(s.req.rid, 1)
                self.ledger.phase(s.req.rid, "decode")
                if self._slot_done(s, tok):
                    self._finish(s, w)
            for w, first in zip(admitted, first_host):
                s = self.slots[w]
                tok = int(first)
                s.pending_first = None
                s.generated.append(tok)
                s.cur_token = tok
                self.ledger.note_first_token(s.req.rid)
                self.ledger.note_tokens(s.req.rid, 1)
                self.ledger.phase(s.req.rid, "decode")
                if self._slot_done(s, tok):
                    self._finish(s, w)
        self._step_idx += 1
        if self.registry is not None and getattr(self.registry, "enabled",
                                                 False):
            # serve.* gauges refreshed every scheduler step (host
            # arithmetic over the ledger), so the registry's next flush,
            # and the live scrape riding it, carry the current picture
            self.ledger.observe(self.registry)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def run(self, max_steps: int = 100_000) -> Dict[str, ServedResult]:
        """Step until the queue and every slot drain (or ``max_steps``,
        a runaway backstop).  Returns rid -> :class:`ServedResult`."""
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.results
