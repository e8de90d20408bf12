"""Parallel plans: one point of the parallelism space, how to apply it,
and the cost model that ranks them.

Counterpart of ``apex_tpu/parallel/plan.py``.  :class:`Plan` holds the
mesh axis sizes (dp x tp x sp x pp x ep), the ZeRO / update-sharding /
collective-scheme knobs and the model's predictions; :attr:`Plan.family`
names the step engine (:mod:`.spmd`) that materialises it, and
:meth:`Plan.apply` builds the named mesh (:func:`~apex_tpu_torch.
parallel.mesh.create_mesh`) and engages the knobs through their
environment surfaces for the duration of a context, so a knob-less
``DistributedDataParallel()`` inside resolves to exactly the plan's
choices.

The cost model, arithmetic for arithmetic the JAX package's:

  * **compute time** from :func:`~apex_tpu_torch.telemetry.attrib.
    op_table`'s FLOPs and bytes of one executed step against the
    ceilings row (:func:`~apex_tpu_torch.pyprof.prof.resolve_ceilings`,
    ``h100`` on the card), split into the train part (divided by every
    axis) and the optimizer update (replicated, or 1/dp when sharded);
  * an **alpha-beta collective model** (ring all-reduce /
    reduce-scatter / all-gather / all-to-all / ppermute) over the axis
    size, link rate and per-hop latency, with the wire bytes of the
    chosen collective scheme and its codec's passes over memory;
  * an **HBM model** from :func:`~apex_tpu_torch.telemetry.memory.
    memory_model`'s classes, scaled per axis.

:func:`search` enumerates the plans for a chip count, prunes those that
do not fit, and ranks the rest by predicted step time, near ties going
to the simpler plan.  :func:`from_tuning` reads the measured winner
plan from the tuning profile (:mod:`apex_tpu_torch.utils.tuning`), and a
plan tuned at another chip count goes through the elastic re-plan hook
(:func:`set_replan_hook`).  ``build_flagship_step`` lives in
:mod:`apex_tpu_torch.train`.

CLI::

    python -m apex_tpu_torch.parallel.plan --chips 8 --model flagship
    python -m apex_tpu_torch.parallel.plan --artifact PLAN_AB.json
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from . import collectives as _coll
from . import weight_update as _wu
from .expert import EXPERT_AXIS
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, create_mesh,
                   use_mesh)
from .pipeline import PIPE_AXIS

__all__ = [
    "ModelProfile", "Plan", "profile_step", "flagship_profile",
    "collective_time_s", "compute_time_s", "predict", "plan_hbm_bytes",
    "resolve_overlap_fraction", "ENV_OVERLAP", "enumerate_plans", "search",
    "default_plan", "set_replan_hook", "get_replan_hook", "from_tuning",
    "format_plans",
    "PLAN_SCHEMES", "TUNING_KEYS", "EP_DEFAULT_EXPERTS",
]

#: wire schemes the search enumerates for the dp gradient exchange
#: (``adasum`` changes the reduction rule and is never auto-selected;
#: the parameter all-gather of update-sharded plans stays fp32)
PLAN_SCHEMES = ("fp32", "bf16", "int8_blockscale")

#: the fused-flat update's cost per parameter: ~10 FLOPs of Adam and 28
#: bytes (read g / p / m / v, write p / m / v, fp32), split out of the
#: profiled totals so that a sharded update scales only this part
UPDATE_FLOPS_PER_PARAM = 10.0
UPDATE_BYTES_PER_PARAM = 28.0

#: predictions within this relative band of the best are ties, broken
#: toward the simpler plan
DEFAULT_TIE_TOL = 0.03

#: sequence-parallel candidates only for sequences at least this long
SP_MIN_SEQ = 2048

#: expert count the ep engine gives a dense model's MoE variant, and the
#: ep cost model assumes for a dense profile
EP_DEFAULT_EXPERTS = 8

#: the comm model's overlap factor (the exposed share of the dp wire):
#: an explicit ``predict`` argument > this variable > the tuning profile's
#: ``overlap_fraction_<scheme>`` > its ``overlap_measured_fraction`` > 1.0
#: (fully exposed)
ENV_OVERLAP = "APEX_TPU_OVERLAP_FRACTION"


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def resolve_overlap_fraction(explicit: Optional[float] = None, *,
                             scheme: Optional[str] = None) -> float:
    """The dp wire's exposed fraction, clamped to [0, 1].  Precedence:
    ``explicit`` > ``APEX_TPU_OVERLAP_FRACTION`` > the tuning profile's
    ``overlap_fraction_<scheme>`` (when ``scheme`` is given: how much wire
    bucketed execution hides depends on the wire's bytes) > its
    ``overlap_measured_fraction`` > 1.0."""
    if explicit is None:
        env = os.environ.get(ENV_OVERLAP)
        if env:
            explicit = float(env)
        else:
            from ..utils import tuning
            v = tuning.get(f"overlap_fraction_{scheme}") if scheme else None
            if not _is_number(v):
                v = tuning.get("overlap_measured_fraction")
            explicit = v if _is_number(v) else 1.0
    return min(max(float(explicit), 0.0), 1.0)


# ---------------------------------------------------------------------------
# model profile: the planner's view of one training step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Cost-model inputs for the GLOBAL training step as one device's
    program (global batch, forward + backward + update), the quantity
    every axis divides.  Built by :func:`profile_step` from one executed
    step, or by hand for the closed-form tests."""
    name: str
    flops: float                  # total step FLOPs
    bytes_accessed: float         # total step memory traffic
    params_bytes: int             # memory_model()'s liveness classes
    optimizer_bytes: int
    activations_bytes: int
    batch_bytes: int
    temps_bytes: int
    output_bytes: int
    args_bytes: int = 0
    constants_bytes: int = 0
    peak_hbm_bytes: int = 0       # the one-device peak
    grad_bytes: int = 0           # dp exchange payload (default: params)
    layers: int = 0               # transformer facts for the tp / sp model
    act_layer_bytes: int = 0      # one layer's activation (B * S * D * 4)
    seq: int = 0
    heads: int = 1
    global_batch: int = 0         # for the pp microbatch lattice
    experts: int = 0              # MoE expert count (0: dense)
    capacity_factor: float = 1.25  # ep router capacity factor
    platform: str = "cpu"
    collective_bytes: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.grad_bytes == 0:
            object.__setattr__(self, "grad_bytes", self.params_bytes)


def profile_step(fn, *args, name: str = "step", cfg=None,
                 global_batch: Optional[int] = None,
                 **kwargs) -> ModelProfile:
    """Run ``fn(*args, **kwargs)`` once under :func:`~apex_tpu_torch.
    telemetry.attrib.op_table` (FLOPs, bytes, the collectives it issued)
    and once under :func:`~apex_tpu_torch.telemetry.memory.memory_model`
    (the per-class memory), and distill the profile; the JAX package
    compiles the step ahead of time instead.  ``cfg`` (a
    :class:`~apex_tpu_torch.models.TransformerConfig`) fills the
    transformer facts of the tp / sp model at ``global_batch``."""
    from ..telemetry import attrib
    from ..telemetry import memory as tmem

    table = attrib.op_table(fn, *args, **kwargs)
    mem = tmem.memory_model(fn, *args, register=False, **kwargs)
    layers = act_layer = seq = experts = 0
    heads = 1
    cap_factor = 1.25
    if cfg is not None:
        layers = int(cfg.num_layers)
        seq = int(cfg.max_len)
        heads = int(cfg.num_heads)
        act_layer = int((global_batch or 1) * seq * cfg.d_model * 4)
        experts = int(getattr(cfg, "num_experts", 0) or 0)
        cap_factor = float(getattr(cfg, "capacity_factor", 1.25))
    coll = {
        op: {"count": agg["count"],
             "logical_bytes": agg["logical_bytes"]}
        for op, agg in (table.get("collectives", {})
                        .get("by_opcode", {})).items()
    }
    return ModelProfile(
        name=name,
        flops=float(table["module_flops"] or table["total_flops"]),
        bytes_accessed=float(table["module_bytes"] or table["total_bytes"]),
        params_bytes=mem["params_bytes"],
        optimizer_bytes=mem["optimizer_bytes"],
        activations_bytes=mem["activations_bytes"],
        batch_bytes=mem["batch_bytes"],
        temps_bytes=mem["temps_bytes"],
        output_bytes=mem["output_bytes"],
        args_bytes=mem.get("args_bytes", 0),
        constants_bytes=mem.get("constants_bytes", 0),
        peak_hbm_bytes=mem["peak_hbm_bytes"],
        layers=layers, act_layer_bytes=act_layer, seq=seq, heads=heads,
        global_batch=int(global_batch or 0), experts=experts,
        capacity_factor=cap_factor,
        platform=table["platform"],
        collective_bytes=coll,
    )


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


def flagship_profile(cfg=None, *, global_batch: Optional[int] = None,
                     device=None, **overrides
                     ) -> Tuple[ModelProfile, object, int]:
    """Profile the flagship train step (fused-flat Adam) on ``device``
    (default the card): BERT-large there, the stand-in on the CPU, at a
    global batch of 8 on both (the JAX package profiles 32 on a TPU; 8
    is the one-card batch its flagship phases run).  Returns
    ``(profile, cfg, global_batch)``."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if cfg is None:
        cfg = _flagship_cfg(dev.type == "cuda", **overrides)
    if global_batch is None:
        global_batch = 8
    step, step_args = _flagship_step(cfg, global_batch, dev)
    prof = profile_step(step, *step_args, name=f"flagship-{cfg.num_layers}L",
                        cfg=cfg, global_batch=global_batch)
    return prof, cfg, global_batch


def _flagship_step(cfg, global_batch: int, device=None):
    """The one-device global train step the profile describes: the loss,
    its gradients and ``FusedAdam(impl="fused").step_flat`` (the update
    the measured plans run, without the collectives a plan adds).
    Returns ``(step, (params, state, tokens))``."""
    import torch
    from ..models import transformer_init, transformer_loss
    from ..optimizers import FusedAdam
    from ..utils.device import resolve_device
    from ..utils.pytree import tree_flatten, tree_unflatten
    dev = resolve_device(device)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    opt = FusedAdam(lr=1e-2, impl="fused")
    state = opt.init(params)
    tokens = torch.zeros((global_batch, cfg.max_len), dtype=torch.long,
                         device=dev)

    def step(params, state, tokens):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = transformer_loss(tree_unflatten(treedef, leaves),
                                {"tokens": tokens, "targets": tokens}, cfg)
        grads = torch.autograd.grad(loss, leaves)
        fl = opt.flattener_for(params)
        new_state = opt.step_flat(state, fl.flatten(
            tree_unflatten(treedef, list(grads))))
        return fl.unflatten(new_state.master, like=params), new_state, \
            loss.detach()

    return step, (params, state, tokens)


# ---------------------------------------------------------------------------
# analytic cost model
# ---------------------------------------------------------------------------

def _resolve_ceil(ceilings=None, platform: Optional[str] = None) -> dict:
    if ceilings is not None:
        return ceilings
    from ..pyprof.prof import resolve_ceilings
    return resolve_ceilings(platform or "cpu")


def compute_time_s(flops: float, nbytes: float, ceil: dict) -> float:
    """Roofline lower bound: compute-bound or bandwidth-bound, whichever
    binds."""
    return max(flops / ceil["peak_flops"], nbytes / ceil["peak_bw"])


#: ring hop counts and per-device traffic factors (alpha-beta:
#: all-reduce = reduce-scatter + all-gather)
_COLL_HOPS = {
    "all_reduce": lambda n: 2 * (n - 1),
    "reduce_scatter": lambda n: n - 1,
    "all_gather": lambda n: n - 1,
    "all_to_all": lambda n: n - 1,
    # a pipeline's stage hop: one neighbour link carries the payload
    "ppermute": lambda n: 1,
}
_COLL_TRAFFIC = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


def _codec_bytes(scheme: str, logical_bytes: float, world: int,
                 kind: str) -> float:
    """Memory traffic a scheme's codec pays per device: the cast or
    quantize out, the dequantize (and sum) in; int8's all-reduce
    dequant-sums every peer's codes, its reduce-scatter one slice."""
    if scheme == "bf16":
        return 2.0 * logical_bytes
    if scheme == "int8_blockscale":
        if kind == "all_reduce":
            return (1.0 + world) * logical_bytes
        return 2.0 * logical_bytes
    return 0.0


def _ab_time(kind: str, wire: float, world: int, alpha: float,
             bw: float) -> float:
    """One alpha-beta term: hops x latency + ring traffic over the link."""
    if world <= 1 or wire <= 0:
        return 0.0
    return (_COLL_HOPS[kind](world) * alpha
            + _COLL_TRAFFIC[kind](world) * wire / bw)


def collective_time_s(kind: str, logical_bytes: float, world: int,
                      ceil: dict, scheme: str = "fp32",
                      block: int = _coll.DEFAULT_BLOCK,
                      slices: int = 1) -> float:
    """Alpha-beta time of one collective of ``logical_bytes`` (fp32 per
    device) over a ``world``-wide axis: per-hop latency, the scheme's
    wire bytes over the link, and its codec's memory passes.  ``slices >
    1`` splits the axis into an inner tier over ``world / slices`` ranks
    (``ici_*``) and an outer one over ``slices`` carrying ``1 / local`` of
    the payload (``dcn_*``); slices that do not divide the axis take the
    flat model."""
    if world <= 1 or logical_bytes <= 0:
        return 0.0
    if kind not in _COLL_HOPS:
        raise ValueError(f"unknown collective kind {kind!r}; "
                         f"known: {tuple(_COLL_HOPS)}")
    nelems = int(logical_bytes) // 4
    wire = float(_coll.wire_bytes(scheme, nelems, block))
    slices = int(slices or 1)
    if slices > 1 and world % slices == 0 and world > slices:
        local = world // slices
        dcn_bw = ceil.get("dcn_bw", ceil["ici_bw"])
        dcn_alpha = ceil.get("dcn_alpha_s", ceil["ici_alpha_s"])
        t = (_ab_time(kind, wire, local, ceil["ici_alpha_s"],
                      ceil["ici_bw"])
             + _ab_time(kind, wire / local, slices, dcn_alpha, dcn_bw))
    else:
        t = _ab_time(kind, wire, world, ceil["ici_alpha_s"],
                     ceil["ici_bw"])
    return t + _codec_bytes(scheme, logical_bytes, world,
                            kind) / ceil["peak_bw"]


def _update_costs(profile: ModelProfile) -> Tuple[float, float]:
    """(flops, bytes) of the optimizer update, capped at half the
    profiled totals so that a degenerate profile cannot drive the train
    part negative."""
    n_params = profile.params_bytes / 4.0
    return (min(UPDATE_FLOPS_PER_PARAM * n_params, 0.5 * profile.flops),
            min(UPDATE_BYTES_PER_PARAM * n_params,
                0.5 * profile.bytes_accessed))


@dataclasses.dataclass
class Plan:
    """One point of the search space: mesh axis sizes + the knob dict,
    with the model's predictions (:func:`predict` fills them).
    :meth:`apply` materialises it; :meth:`knobs` is its serialisable
    form.  ``allgather_scheme`` is the sharded update's parameter
    all-gather wire, which the dp / sp / tp (zero1) and zero engines
    take; the others refuse a non-fp32 one."""
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
    predicted_step_ms: float = 0.0
    predicted_hbm_bytes: int = 0
    hbm_by_class: dict = dataclasses.field(default_factory=dict)
    breakdown: dict = dataclasses.field(default_factory=dict)
    feasible: bool = True

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
        """Does a step engine run this plan?  Every family:
        :func:`~apex_tpu_torch.parallel.spmd.build_plan_step` materialises
        dp, tp, sp, pp, ep and zero."""
        return self.family in ("dp", "tp", "sp", "zero", "pp", "ep")

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
        """Parameter placement for the flagship under this plan: the
        Megatron specs at tp > 1, every leaf ``"replicated"`` otherwise
        (:func:`~apex_tpu_torch.parallel.spmd.plan_param_pspecs`)."""
        from . import spmd as _spmd
        return _spmd.plan_param_pspecs(cfg, self)

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


# ---------------------------------------------------------------------------
# prediction: step time + HBM per replica for one candidate
# ---------------------------------------------------------------------------

def _ep_geometry(profile: ModelProfile, dp: int, ep: int,
                 sp: int = 1) -> Tuple[int, int, int, int]:
    """(E_total, capacity, d_model, tokens_local) of the ep router under
    the plan's axes (the expert layer's own formulas)."""
    E = int(profile.experts or EP_DEFAULT_EXPERTS)
    gb = max(int(profile.global_batch or 1), 1)
    seq = max(int(profile.seq), 1)
    tokens_local = max(gb * seq // max(dp * ep * sp, 1), 1)
    capacity = max(int(profile.capacity_factor * tokens_local / E), 1)
    d_model = max(int(profile.act_layer_bytes) // max(gb * seq * 4, 1), 1)
    return E, capacity, d_model, tokens_local


def plan_hbm_bytes(profile: ModelProfile, plan: Plan) -> Tuple[int, dict]:
    """Per-replica memory at the peak under the plan's axes, scaled from
    ``memory_model()``'s classes: params and optimizer shard over tp x
    pp (the optimizer also over dp when the update is sharded),
    activations and temps over every token / layer axis, the batch over
    dp x sp x ep; args and constants replicate.  pp adds its schedule
    stash (a microbatch block a tick plus the M-deep output buffer), ep
    its capacity buffers (the dispatch / combine one-hots and both
    all-to-all queues, fp32)."""
    dp, tp, sp = plan.dp, plan.tp, plan.sp
    pp, ep = plan.pp_stages, plan.ep
    opt_div = tp * pp * (dp if plan.shards_update else 1)
    by = {
        "params": profile.params_bytes // (tp * pp),
        "optimizer": profile.optimizer_bytes // opt_div,
        "activations": profile.activations_bytes // (dp * tp * sp * pp * ep),
        "batch": profile.batch_bytes // (dp * sp * ep),
        "temps": profile.temps_bytes // (dp * tp * sp * ep),
        "output": profile.output_bytes // (dp * ep),
        "args": profile.args_bytes,
        "constants": profile.constants_bytes,
    }
    if pp > 1:
        m = max(int(plan.pp_microbatches), 1)
        ticks = m + pp - 1
        blk = profile.act_layer_bytes // max(dp * m, 1)
        by["pp_stash"] = int((ticks + m) * blk)
    if ep > 1:
        e_total, cap, d_model, t_local = _ep_geometry(profile, dp, ep, sp)
        by["ep_buffers"] = int(4 * (2 * t_local * e_total * cap
                                    + 2 * e_total * cap * d_model))
    return sum(by.values()), by


def predict(profile: ModelProfile, plan: Plan, ceilings=None,
            platform: Optional[str] = None,
            overlap_fraction: Optional[float] = None) -> Plan:
    """Fill ``plan``'s predicted step time (with its breakdown), memory
    and feasibility against the ceilings' capacity; returns the same
    plan.  Only the dp wire's exposed part (``overlap_fraction``, see
    :func:`resolve_overlap_fraction`) is charged; the tp / sp / pp / ep
    exchanges sit between layer ops and are charged whole, and so is the
    pipeline bubble."""
    ceil = _resolve_ceil(ceilings, platform or profile.platform)
    overlap = resolve_overlap_fraction(
        overlap_fraction,
        scheme=(plan.collective_scheme if plan.family == "dp" else None))
    dp, tp, sp = plan.dp, plan.tp, plan.sp
    pp, ep = plan.pp_stages, plan.ep
    shards = dp * tp * sp * pp * ep

    f_upd, b_upd = _update_costs(profile)
    t_train = compute_time_s((profile.flops - f_upd) / shards,
                             (profile.bytes_accessed - b_upd) / shards,
                             ceil)
    upd_div = tp * pp * (dp if plan.shards_update else 1)
    t_update = compute_time_s(f_upd / upd_div, b_upd / upd_div, ceil)

    t_dp = 0.0
    if dp > 1:
        # only the dp axis spans hosts (num_slices in the ceilings)
        dp_slices = min(dp, int(ceil.get("num_slices", 1) or 1))
        gbytes = profile.grad_bytes / tp
        if plan.shards_update:
            t_dp = (collective_time_s("reduce_scatter", gbytes, dp, ceil,
                                      plan.collective_scheme,
                                      slices=dp_slices)
                    + collective_time_s("all_gather",
                                        profile.params_bytes / tp, dp,
                                        ceil, plan.allgather_scheme,
                                        slices=dp_slices))
        else:
            t_dp = collective_time_s("all_reduce", gbytes, dp, ceil,
                                     plan.collective_scheme,
                                     slices=dp_slices)

    t_tp = 0.0
    if tp > 1:
        # Megatron's column / row pairs: 2 activation all-reduces a layer
        # forward and 2 backward
        act = profile.act_layer_bytes / (dp * sp)
        t_tp = 4 * max(profile.layers, 1) * collective_time_s(
            "all_reduce", act, tp, ceil)

    t_sp = 0.0
    if sp > 1:
        act = profile.act_layer_bytes / (dp * tp)
        if plan.sp_strategy == "ulysses":
            # 4 all-to-alls a layer forward, mirrored backward
            t_sp = 8 * max(profile.layers, 1) * collective_time_s(
                "all_to_all", act / sp, sp, ceil)
        else:
            # the ring: K and V blocks around it each layer, both ways
            t_sp = 2 * max(profile.layers, 1) * collective_time_s(
                "all_gather", 2 * act / sp, sp, ceil)

    t_bubble = t_pp = 0.0
    if pp > 1:
        m = max(int(plan.pp_microbatches), 1)
        # GPipe fill-drain: (S - 1) / M of the train time idles
        t_bubble = t_train * (pp - 1) / m
        blk = profile.act_layer_bytes / max(dp * m, 1)
        t_pp = 2 * (m + pp - 1) * collective_time_s("ppermute", blk, pp,
                                                    ceil)

    t_ep = 0.0
    if ep > 1:
        coll = (profile.collective_bytes or {}).get("all-to-all")
        if coll and coll.get("logical_bytes"):
            # the profiled step's own all-to-all payload (forward;
            # backward mirrors)
            count = max(int(coll.get("count", 1)), 1)
            t_ep = 2 * count * collective_time_s(
                "all_to_all", float(coll["logical_bytes"]) / count, ep,
                ceil)
        else:
            # the (E_total * capacity, D) queue both ways a MoE layer,
            # forward and backward
            e_total, cap, d_model, _ = _ep_geometry(profile, dp, ep, sp)
            a2a = 4.0 * e_total * cap * d_model
            t_ep = 4 * max(profile.layers, 1) * collective_time_s(
                "all_to_all", a2a, ep, ceil)

    t_dp_exposed = t_dp * overlap
    total_s = (t_train + t_update + t_dp_exposed + t_tp + t_sp
               + t_bubble + t_pp + t_ep)
    hbm, by = plan_hbm_bytes(profile, plan)
    plan.predicted_step_ms = total_s * 1e3
    plan.predicted_hbm_bytes = int(hbm)
    plan.hbm_by_class = by
    plan.breakdown = {
        "train_ms": t_train * 1e3, "update_ms": t_update * 1e3,
        "dp_comm_ms": t_dp * 1e3,
        "dp_comm_exposed_ms": t_dp_exposed * 1e3,
        "overlap_fraction": overlap,
        "tp_comm_ms": t_tp * 1e3,
        "sp_comm_ms": t_sp * 1e3,
        "pp_bubble_ms": t_bubble * 1e3,
        "pp_comm_ms": t_pp * 1e3,
        "ep_comm_ms": t_ep * 1e3,
    }
    plan.feasible = hbm <= ceil["hbm_bytes"]
    return plan


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _factorizations(chips: int):
    """(dp, tp, sp, pp, ep) with dp*tp*sp*pp*ep == chips (the dp x tp
    plane first, then pp, then ep)."""
    chips = int(chips)
    for ep in range(1, chips + 1):
        if chips % ep:
            continue
        r1 = chips // ep
        for pp in range(1, r1 + 1):
            if r1 % pp:
                continue
            r2 = r1 // pp
            for sp in range(1, r2 + 1):
                if r2 % sp:
                    continue
                rest = r2 // sp
                for tp in range(1, rest + 1):
                    if rest % tp:
                        continue
                    yield rest // tp, tp, sp, pp, ep


def _pp_microbatch_options(profile: ModelProfile, dp: int) -> List[int]:
    """Microbatch counts M for a pp plan at ``dp`` replicas: divisors of
    the per-replica batch, at most 8."""
    b_rep = int(profile.global_batch or 0) // max(dp, 1)
    if b_rep < 1:
        return []
    return [m for m in (1, 2, 4, 8) if m <= b_rep and b_rep % m == 0]


def enumerate_plans(profile: ModelProfile, chips: int, *,
                    ceilings=None, platform: Optional[str] = None,
                    schemes: Sequence[str] = PLAN_SCHEMES,
                    allow_tp: bool = True, allow_sp: bool = True,
                    allow_pp: bool = True, allow_ep: bool = True,
                    sp_min_seq: int = SP_MIN_SEQ) -> List[Plan]:
    """Every candidate, predicted (feasible or not; :func:`search`
    prunes).  tp only for layered models, up to the head count; sp only
    for sequences of at least ``sp_min_seq`` that it divides, with dp
    only; pp only when the stages divide the layers and a microbatch
    lattice exists, with dp only; ep only when the width divides the
    expert count, with dp only; schemes and update-sharding variants
    only where a dp wire exists, the tp family at fp32 wire, zero with
    dp alone, and pp / ep with the plain update (what the engines run)."""
    ceil = _resolve_ceil(ceilings, platform or profile.platform)
    plans: List[Plan] = []
    for dp, tp, sp, pp, ep in _factorizations(chips):
        if tp > 1 and (not allow_tp or profile.layers <= 0
                       or tp > profile.heads):
            continue
        if sp > 1:
            if (not allow_sp or profile.seq < sp_min_seq
                    or profile.seq % sp or tp > 1 or pp > 1 or ep > 1):
                continue
            strategies = ["ring"]
            if profile.heads % sp == 0:
                strategies.append("ulysses")
        else:
            strategies = ["none"]
        micro_opts = [1]
        if pp > 1:
            if (not allow_pp or profile.layers <= 0 or pp > profile.layers
                    or profile.layers % pp or tp > 1 or sp > 1 or ep > 1):
                continue
            micro_opts = _pp_microbatch_options(profile, dp)
            if not micro_opts:
                continue
        if ep > 1:
            e_total = int(profile.experts or EP_DEFAULT_EXPERTS)
            if (not allow_ep or profile.layers <= 0 or e_total % ep
                    or tp > 1 or sp > 1 or pp > 1):
                continue
        variants = [("off", False)]
        if dp > 1 and pp == 1 and ep == 1:
            variants.append(("zero1", False))
            if tp == 1 and sp == 1:
                variants.append(("off", True))
        dp_schemes = schemes if (dp > 1 and tp == 1) else ("fp32",)
        for strat in strategies:
            for scheme in dp_schemes:
                for us, zero in variants:
                    for m in micro_opts:
                        plans.append(predict(profile, Plan(
                            dp=dp, tp=tp, sp=sp, sp_strategy=strat,
                            pp_stages=pp, pp_microbatches=m, ep=ep,
                            zero=zero, update_sharding=us,
                            collective_scheme=scheme), ceilings=ceil))
    return plans


def search(profile: ModelProfile, chips: int, *,
           ceilings=None, platform: Optional[str] = None,
           capacity_bytes: Optional[int] = None,
           tie_tol: float = DEFAULT_TIE_TOL,
           **enum_kwargs) -> List[Plan]:
    """Ranked feasible plans for ``chips`` devices: enumerate, drop every
    plan whose per-replica memory exceeds the capacity (the ceilings'
    ``hbm_bytes`` unless ``capacity_bytes`` overrides), rank by predicted
    step time, and break ties within ``tie_tol`` toward the simpler plan.
    Host arithmetic only: no step runs, nothing syncs."""
    ceil = dict(_resolve_ceil(ceilings, platform or profile.platform))
    if capacity_bytes is not None:
        ceil["hbm_bytes"] = float(capacity_bytes)
    if "num_slices" not in ceil:
        from .mesh import num_slices as _num_slices
        ceil["num_slices"] = _num_slices()
    plans = [p for p in enumerate_plans(profile, chips, ceilings=ceil,
                                        **enum_kwargs) if p.feasible]
    plans.sort(key=lambda p: p.predicted_step_ms)
    if plans:
        best = plans[0].predicted_step_ms
        band = best * (1.0 + tie_tol)
        plans.sort(key=lambda p: (
            p.predicted_step_ms if p.predicted_step_ms > band else best,
            p.complexity, p.predicted_step_ms))
    return plans


# ---------------------------------------------------------------------------
# hooks, rendering, CLI
# ---------------------------------------------------------------------------

#: the tuning-profile keys of a measured winner plan (:func:`from_tuning`)
TUNING_KEYS = ("plan_dp", "plan_tp", "plan_sp", "plan_sp_strategy",
               "plan_pp_stages", "plan_pp_microbatches", "plan_ep",
               "plan_zero", "plan_update_sharding",
               "plan_collective_scheme", "plan_allgather_scheme")

#: the elastic re-plan hook, ``hook(plan, chips) -> Optional[Plan]``: a
#: plan tuned at one chip count re-runs the search at another
_REPLAN_HOOK = None


def set_replan_hook(hook):
    """Install the chips-mismatch re-plan hook (None uninstalls);
    returns the previous one."""
    global _REPLAN_HOOK
    prev = _REPLAN_HOOK
    _REPLAN_HOOK = hook
    return prev


def get_replan_hook():
    return _REPLAN_HOOK


def from_tuning(chips: Optional[int] = None, *,
                gpu_only: bool = True) -> Optional[Plan]:
    """The measured winner plan of the tuning profile (the ``plan_*``
    keys), or None when the profile has none.  With ``chips`` given, a
    plan tuned at another chip count is a re-plan trigger when the
    elastic hook is installed (:func:`set_replan_hook`: the hook re-runs
    the search at the live count), else None: a winner measured at one
    chip count says nothing about another.  ``gpu_only`` reads the
    profile as runtime defaults do (only on the card,
    :func:`~apex_tpu_torch.utils.tuning.get_on_gpu`); pass False for
    rendering and tooling.  The JAX package's flag is ``tpu_only``."""
    from ..utils import tuning
    get = tuning.get_on_gpu if gpu_only else tuning.get
    dp = get("plan_dp")
    if dp is None:
        return None
    plan = Plan(
        dp=int(dp), tp=int(get("plan_tp", 1)), sp=int(get("plan_sp", 1)),
        sp_strategy=get("plan_sp_strategy", "none"),
        pp_stages=int(get("plan_pp_stages", 1) or 1),
        pp_microbatches=int(get("plan_pp_microbatches", 1) or 1),
        ep=int(get("plan_ep", 1) or 1),
        zero=bool(get("plan_zero", False)),
        update_sharding=get("plan_update_sharding", "off"),
        collective_scheme=get("plan_collective_scheme", "fp32"),
        allgather_scheme=get("plan_allgather_scheme", "fp32"),
    )
    if chips is not None and plan.chips != int(chips):
        if _REPLAN_HOOK is not None:
            return _REPLAN_HOOK(plan, int(chips))
        return None
    return plan


def _human_bytes(n) -> str:
    from ..telemetry.memory import _human
    return _human(n, "B")


def format_plans(plans: Sequence[Plan], *, chips: Optional[int] = None,
                 measured: Optional[Dict[int, float]] = None,
                 top: int = 12) -> str:
    """The ranked plan table: predicted ms (and the comm breakdown),
    memory a replica, the knobs; ``measured`` maps a plan's index to its
    measured ms."""
    measured = measured or {}
    head = "auto-parallel plans"
    if chips:
        head += f" @ {chips} chips"
    lines = [
        head,
        f"{'rank':<5}{'pred ms':>9} {'meas ms':>9} {'HBM/replica':>12}  "
        f"{'comm ms (dp/tp/sp)':>20}  plan",
    ]
    for i, p in enumerate(plans[:top]):
        b = p.breakdown or {}
        comm = (f"{b.get('dp_comm_ms', 0.0):.2f}/"
                f"{b.get('tp_comm_ms', 0.0):.2f}/"
                f"{b.get('sp_comm_ms', 0.0):.2f}")
        m = measured.get(i)
        lines.append(
            f"{i:<5}{p.predicted_step_ms:>9.3f} "
            f"{(f'{m:.3f}' if m is not None else '-'):>9} "
            f"{_human_bytes(p.predicted_hbm_bytes):>12}  {comm:>20}  "
            f"{p.describe() or 'all-defaults'}")
    if len(plans) > top:
        lines.append(f"... {len(plans) - top} more feasible plans")
    if plans:
        lines.append(f"winner knobs: {plans[0].knobs()}")
    return "\n".join(lines)


def _plans_from_artifact(art: dict) -> Tuple[List[Plan], Dict[int, float]]:
    """(plans, measured) from a plan artifact: a whole bench document
    (``detail.plan``), a ``plan_ab`` one (``plan``) or a bare plan leg."""
    leg = art
    for key in ("detail", "plan"):
        if isinstance(leg, dict) and key in leg:
            leg = leg[key]
    rows = (leg or {}).get("plans") if isinstance(leg, dict) else None
    if not rows:
        raise ValueError("artifact carries no plan leg "
                         "(expected detail.plan.plans / plan.plans)")
    plans, measured = [], {}
    for i, row in enumerate(rows):
        kn = dict(row.get("knobs") or {})
        plans.append(Plan(
            dp=kn.get("dp", 1), tp=kn.get("tp", 1), sp=kn.get("sp", 1),
            sp_strategy=kn.get("sp_strategy", "none"),
            pp_stages=kn.get("pp_stages", 1),
            pp_microbatches=kn.get("pp_microbatches", 1),
            ep=kn.get("ep", 1),
            zero=kn.get("zero", False),
            update_sharding=kn.get("update_sharding", "off"),
            collective_scheme=kn.get("collective_scheme", "fp32"),
            allgather_scheme=kn.get("allgather_scheme", "fp32"),
            predicted_step_ms=row.get("predicted_ms") or 0.0,
            predicted_hbm_bytes=row.get("hbm_bytes") or 0,
        ))
        if isinstance(row.get("measured_ms"), (int, float)):
            measured[i] = float(row["measured_ms"])
    return plans, measured


def _main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Auto-parallel planner: the ranked plan table from a "
                    "plan artifact or from a profile of the flagship step "
                    "run once on the device.")
    ap.add_argument("--chips", type=int, default=None,
                    help="device count to plan for (default: the cards "
                         "on this host, 1 on the CPU)")
    ap.add_argument("--model", default="flagship",
                    help="model to profile (flagship: BERT-large on the "
                         "card, its small stand-in on the CPU)")
    ap.add_argument("--layers", type=int)
    ap.add_argument("--batch", type=int, help="GLOBAL batch")
    ap.add_argument("--seq", type=int)
    ap.add_argument("--device", default="cuda",
                    help="where the profiled step runs (cuda or cpu)")
    ap.add_argument("--artifact",
                    help="render a measured plan artifact instead of "
                         "running the cost model")
    ap.add_argument("--capacity-gb", type=float,
                    help="override the memory capacity the feasibility "
                         "check prunes against")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    if args.artifact:
        with open(args.artifact) as f:
            art = json.load(f)
        plans, measured = _plans_from_artifact(art)
        print(format_plans(plans, measured=measured, top=args.top))
        return 0

    if args.model != "flagship":
        ap.error(f"unknown model {args.model!r} (only 'flagship')")
    import torch
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    chips = args.chips or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    overrides = {}
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.seq:
        overrides["max_len"] = args.seq
    prof, cfg, gb = flagship_profile(global_batch=args.batch, device=dev,
                                     **overrides)
    cap = int(args.capacity_gb * 1e9) if args.capacity_gb else None
    ranked = search(prof, chips, capacity_bytes=cap)
    n_all = len(enumerate_plans(prof, chips))
    print(f"profiled {prof.name} (global batch {gb}, seq {cfg.max_len}) "
          f"on {prof.platform}: {prof.flops / 1e9:.2f} GFLOP/step, "
          f"peak {_human_bytes(prof.peak_hbm_bytes)}")
    print(f"{n_all} candidates, {len(ranked)} HBM-feasible")
    print(format_plans(ranked, chips=chips, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
