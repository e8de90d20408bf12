"""Parallel plans: one point of the parallelism space and how to apply it.

Counterpart of ``apex_tpu/parallel/plan.py``, its :class:`Plan` part: the
mesh axis sizes (dp x tp x sp x pp x ep), the ZeRO / update-sharding /
collective-scheme knobs, which step engine (:mod:`.spmd`) materialises
the plan (:attr:`Plan.family`), and :meth:`Plan.apply`, which builds the
named mesh (:func:`~apex_tpu_torch.parallel.mesh.create_mesh`) and engages
the knobs through their environment surfaces for the duration of a
context, so a knob-less ``DistributedDataParallel()`` inside resolves to
exactly the plan's choices.

The cost model and the search over plans (``ModelProfile``,
``profile_step``, ``predict``, ``search``, the tuning loop and the CLI),
with the fields and constants only they read (a plan's predictions and
feasibility, ``PLAN_SCHEMES``, ``SP_MIN_SEQ``, ``DEFAULT_TIE_TOL``, the
update's cost per parameter, ``ENV_OVERLAP``), are not ported yet, nor
the tensor-parallel parameter specs (:meth:`Plan.pspecs` at tp > 1);
ROADMAP.md queues them.  ``build_flagship_step`` lives in
:mod:`apex_tpu_torch.train`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Sequence

from . import collectives as _coll
from . import weight_update as _wu
from .expert import EXPERT_AXIS
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, create_mesh,
                   use_mesh)
from .pipeline import PIPE_AXIS

__all__ = ["Plan", "default_plan", "EP_DEFAULT_EXPERTS"]

#: expert count the ep engine gives a dense model's MoE variant
EP_DEFAULT_EXPERTS = 8


def _flagship_cfg(on_gpu: bool, **overrides):
    """The flagship config: BERT-large on the card, else the small
    stand-in of the same structure (stacked layers, tied embeddings) the
    tests run — the JAX package's ``_flagship_cfg(on_tpu)``."""
    from ..models import bert_large_config
    if on_gpu:
        return bert_large_config(**overrides)
    base = dict(num_layers=2, d_model=128, d_ff=512, vocab_size=1024,
                max_len=64, num_heads=4)
    base.update(overrides)
    return bert_large_config(**base)


@dataclasses.dataclass
class Plan:
    """One point of the search space: mesh axis sizes + the knob dict.
    :meth:`apply` materialises it; :meth:`knobs` is its serialisable
    form.  ``allgather_scheme`` is the sharded update's parameter
    all-gather wire, which the dp / sp (zero1) and zero engines take;
    the others refuse a non-fp32 one."""
    dp: int = 1
    tp: int = 1
    sp: int = 1
    sp_strategy: str = "none"          # none | ring | ulysses
    pp_stages: int = 1                 # GPipe stages (the pipe mesh axis)
    pp_microbatches: int = 1           # M in-flight microbatches per replica
    ep: int = 1                        # expert-parallel width (expert axis)
    zero: bool = False                 # contrib ZeRO optimizer route
    update_sharding: str = "off"       # off | zero1 (parallel.weight_update)
    collective_scheme: str = "fp32"    # dp gradient wire
    allgather_scheme: str = "fp32"     # sharded-update param allgather wire

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.sp * self.pp_stages * self.ep

    @property
    def shards_update(self) -> bool:
        """Does the optimizer update run on 1/dp slices?"""
        return self.zero or self.update_sharding == "zero1"

    @property
    def complexity(self) -> int:
        """Knobs engaged — the tie-break rank (simpler wins a tie)."""
        return ((self.tp > 1) + (self.sp > 1) + (self.pp_stages > 1)
                + (self.ep > 1) + 2 * self.zero
                + (self.update_sharding != "off")
                + (self.collective_scheme != "fp32")
                + (self.allgather_scheme != "fp32"))

    @property
    def family(self) -> str:
        """The step engine (:mod:`.spmd`) that materialises this plan:
        ``zero`` / ``tp`` / ``sp`` / ``pp`` / ``ep`` / ``dp``."""
        if self.zero:
            return "zero"
        if self.tp > 1:
            return "tp"
        if self.sp > 1:
            return "sp"
        if self.pp_stages > 1:
            return "pp"
        if self.ep > 1:
            return "ep"
        return "dp"

    @property
    def measurable(self) -> bool:
        """Does a step engine run this plan?  Every family but tp, whose
        engine is queued (:func:`~apex_tpu_torch.parallel.spmd.
        build_plan_step` raises for it); in the JAX package every
        family."""
        return self.family != "tp"

    def axis_sizes(self) -> Dict[str, int]:
        """``create_mesh`` axis dict — size-1 axes are omitted (except
        ``data``, always present)."""
        axes = {DATA_AXIS: self.dp}
        if self.tp > 1:
            axes[MODEL_AXIS] = self.tp
        if self.sp > 1:
            axes[SEQ_AXIS] = self.sp
        if self.pp_stages > 1:
            axes[PIPE_AXIS] = self.pp_stages
        if self.ep > 1:
            axes[EXPERT_AXIS] = self.ep
        return axes

    def knobs(self) -> dict:
        return {
            "dp": self.dp, "tp": self.tp, "sp": self.sp,
            "sp_strategy": self.sp_strategy,
            "pp_stages": self.pp_stages,
            "pp_microbatches": self.pp_microbatches,
            "ep": self.ep, "zero": self.zero,
            "update_sharding": self.update_sharding,
            "collective_scheme": self.collective_scheme,
            "allgather_scheme": self.allgather_scheme,
        }

    def env(self) -> Dict[str, str]:
        """The env-knob rendering of this plan (the knobs that have env
        surfaces).  ``fp32`` wire / ``off`` sharding emit nothing."""
        env = {}
        if self.collective_scheme != "fp32":
            env[_coll.ENV_KNOB] = self.collective_scheme
        if self.update_sharding != "off":
            env[_wu.ENV_KNOB] = self.update_sharding
        return env

    def pspecs(self, cfg):
        """Parameter placement for the flagship under this plan: every
        leaf replicated (``"replicated"``) at tp == 1, as the JAX package's
        ``P()``; the tensor-parallel specs are not ported yet."""
        if self.tp > 1:
            raise NotImplementedError(
                "tensor-parallel parameter specs (tp > 1) are not ported "
                "yet: they come with the tp engine in the next slice of "
                "the port (ROADMAP.md, Queue 1 item 7)")
        import torch
        from ..models import transformer_init
        from ..utils.pytree import tree_map
        # the tree's structure, from a one-of-everything copy of cfg
        tiny = dataclasses.replace(cfg, vocab_size=1, max_len=1,
                                   num_layers=1, d_model=cfg.num_heads,
                                   d_ff=1)
        params = transformer_init(tiny, torch.Generator().manual_seed(0),
                                  device="cpu")
        return tree_map(lambda _: "replicated", params)

    @contextlib.contextmanager
    def apply(self, ranks: Optional[Sequence[int]] = None):
        """Materialise the plan: build the mesh (``create_mesh`` over
        ``ranks``, default every rank; collective) and make it ambient,
        and engage the knobs through their env surfaces, for the duration
        of the context.  The knobs this plan leaves at default are
        cleared inside too (an ambient A/B setting must not override the
        plan), and everything is restored on exit."""
        mesh = create_mesh(self.axis_sizes(), ranks)
        env = self.env()
        saved = {k: os.environ.get(k) for k in env}
        for k in (_coll.ENV_KNOB, _wu.ENV_KNOB):
            if k not in env and k in os.environ:
                saved[k] = os.environ.pop(k)
        try:
            os.environ.update(env)
            with use_mesh(mesh):
                yield mesh
        finally:
            for k in set(env) | set(saved):
                os.environ.pop(k, None)
                if saved.get(k) is not None:
                    os.environ[k] = saved[k]

    def describe(self) -> str:
        bits = [f"dp={self.dp}"]
        if self.tp > 1:
            bits.append(f"tp={self.tp}")
        if self.sp > 1:
            bits.append(f"sp={self.sp}:{self.sp_strategy}")
        if self.pp_stages > 1:
            bits.append(f"pp={self.pp_stages}x{self.pp_microbatches}")
        if self.ep > 1:
            bits.append(f"ep={self.ep}")
        if self.zero:
            bits.append("zero")
        if self.update_sharding != "off":
            bits.append(f"us={self.update_sharding}")
        if self.collective_scheme != "fp32":
            bits.append(self.collective_scheme)
        if self.allgather_scheme != "fp32":
            bits.append(f"ag={self.allgather_scheme}")
        return " ".join(bits)


def default_plan(chips: int) -> Plan:
    """The all-defaults baseline: pure data parallelism, fp32 wire,
    replicated update."""
    return Plan(dp=int(chips))
