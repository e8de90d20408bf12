"""The plan step engine: materialise a :class:`~apex_tpu_torch.parallel.
plan.Plan` as an executable, metered train step of the flagship
transformer.

Counterpart of ``apex_tpu/parallel/spmd.py``.  Each rank runs the step
body over its own block of the batch; the mesh's process groups
(:func:`~apex_tpu_torch.parallel.mesh.create_mesh`, which
:meth:`Plan.apply` builds) carry the collectives:

``dp``
    :func:`~apex_tpu_torch.train.build_flagship_step`: the DDP reduction
    (its overlap mode, resolved here, in ``info``) and the fused-flat
    Adam or the zero1 :class:`~apex_tpu_torch.parallel.weight_update.
    ShardedUpdate`.
``sp``
    the attention core through :func:`~apex_tpu_torch.parallel.sequence.
    ring_attention` / ``ulysses_attention`` (the transformer's
    ``attn_override``, position rows at each rank's global offset),
    gradients summed over ``seq`` and divided by its size, then the DDP
    reduction over ``data`` (or zero1's ``ShardedUpdate.step``).  The
    ring / Ulysses wire is metered from the static schedule
    (:func:`_sp_schedule_bytes`), as the JAX engine meters it.
``pp``
    the stacked layers cut into one contiguous slice per ``pipe`` rank,
    microbatches through :func:`~apex_tpu_torch.parallel.pipeline.
    pipeline_apply`, the head and loss masked to the last stage (so the
    tied embedding's gradient is counted once), embedding and head
    gradients summed over ``pipe``, a fused-flat Adam per stage with the
    overflow select, the goodput ledger's pipeline bubble, and the static
    ``ppermute`` schedule (:func:`_pp_schedule_bytes`) metered.
``ep``
    the MoE variant (:func:`_moe_cfg_from`) with its expert stacks sharded
    over ``expert``; dense gradients summed over ``expert`` and divided by
    its size, expert gradients only divided (the backward exchange already
    brought every peer's part to the owner), then the DDP reduction over
    ``data``.  At ``ep == 1`` this is the dp-MoE twin.  Each exchange
    records its bytes (family ``ep``) as it runs.
``zero``
    :class:`~apex_tpu_torch.contrib.optimizers.DistributedFusedAdam` over
    ``data`` (:func:`~apex_tpu_torch.train.zero_train_step`).
``tp``
    Megatron's column / row splits over ``model`` (the transformer's
    ``tp_group`` path, :func:`~apex_tpu_torch.models.transformer.
    tp_shard_params`): each rank holds its shards and the replicated
    leaves, runs the plain attention and the vocab-parallel cross-entropy
    (the JAX engine forces ``attn_impl="default"``, ``xent_impl="xla"``),
    reduces its gradients over ``data`` (fp32 wire) and updates a
    fused-flat Adam over its own leaves (or zero1's ``ShardedUpdate`` of
    that flat over ``data``), the finite flag a MIN over the whole mesh so
    that every rank skips together.  ``amp_dtype="bfloat16"`` runs the
    model copy in bf16 off the fp32 master.  The JAX engine lets GSPMD
    place the collectives and meters its compiled program; the port
    issues Megatron's all-reduces itself and meters the executed ones
    (``tp.psum``).

``build_plan_step`` returns ``(carry0, step, info)``; ``step(carry,
tokens)`` takes the GLOBAL ``(global_batch, seq)`` tokens, as the JAX
step does, takes this rank's block of them, and returns ``(carry,
loss)``, the loss the global-batch mean on every rank.  ``info`` keeps
the JAX keys; where the JAX engine reads its compiled program
(``collectives``, ``metered``), the port fills them from the first
executed step (:func:`~apex_tpu_torch.parallel.comm.recording`: the
collectives the engine itself issues — ring rotations, Ulysses and
expert exchanges, pipeline hops and sums, Megatron's all-reduces — by
opcode; the DDP wire keeps its own ``ddp.*`` meters).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

import dataclasses

from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Placement
from ..utils.device import resolve_device
from ..utils.pytree import (tree_flatten, tree_leaves_with_path, tree_map,
                            tree_map_with_path, tree_unflatten)

__all__ = ["build_plan_step", "plan_param_pspecs", "serve_shardings",
           "SPMD_FAMILIES"]

#: plan families the JAX engine materialises (Plan.family values)
SPMD_FAMILIES = ("dp", "tp", "sp", "zero", "pp", "ep")


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def plan_param_pspecs(cfg, plan):
    """The placement tree of ``cfg``'s parameters under ``plan``: the
    Megatron specs of :func:`~apex_tpu_torch.models.transformer.
    transformer_pspecs` at tp > 1, every leaf ``"replicated"`` otherwise
    (the dp wire reduces gradients; sp shards activations)."""
    from ..models.transformer import REPLICATED, transformer_pspecs
    specs = transformer_pspecs(cfg, dp=DATA_AXIS, tp=MODEL_AXIS)
    if plan.tp > 1:
        return specs
    return tree_map(lambda _: REPLICATED, specs)


def serve_shardings(mesh, cfg, *, packed):
    """The serving engine's placements over ``mesh``: ``{"params": ...,
    "kv": ...}``.  With a ``model`` axis the parameters take the Megatron
    specs and the KV pools ``(L, pages, page_size, H, hd)`` split dim 3
    (each rank pages its own heads); the int8 O-level's packed
    ``(codes, scales)`` list stays whole on every rank (block-scale codes
    do not slice along Megatron dims; the engine slices after the
    dequantize), the pools still split."""
    from ..models.transformer import REPLICATED, transformer_pspecs
    tp = int(mesh.shape.get(MODEL_AXIS, 1))
    if tp > 1 and cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by "
                         f"model-axis size {tp}")
    if tp > 1 and isinstance(packed, dict):
        params = transformer_pspecs(cfg, dp=DATA_AXIS, tp=MODEL_AXIS)
    else:
        params = tree_map(lambda _: REPLICATED, packed)
    kv = f"{MODEL_AXIS}:3" if tp > 1 else REPLICATED
    return {"params": params, "kv": kv}


# ---------------------------------------------------------------------------
# static schedules (the JAX engine's formulas)
# ---------------------------------------------------------------------------

def _esize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _sp_schedule_bytes(cfg, strategy: str, n_dp: int, n_sp: int,
                       global_batch: int) -> dict:
    """Per-rank wire bytes of one sp step: Ulysses ships 4 all_to_alls of
    one local (B_local, H, S_local, hd) block per layer forward and the
    mirrored backward; the ring rotates the K and V blocks around the full
    ring each layer, forward and backward."""
    blk = ((global_batch // n_dp) * cfg.num_heads
           * (cfg.max_len // n_sp) * cfg.head_dim * _esize(cfg.dtype))
    layers = max(int(cfg.num_layers), 1)
    if strategy == "ulysses":
        return {"op": "all_to_all", "logical_bytes": 8 * layers * blk,
                "per_layer_block_bytes": blk, "layers": layers}
    return {"op": "ppermute", "logical_bytes": 4 * layers * n_sp * blk,
            "per_layer_block_bytes": blk, "layers": layers}


def _pp_schedule_bytes(cfg, n_dp: int, n_pp: int, microbatches: int,
                       global_batch: int) -> dict:
    """Per-rank wire bytes of one pp step: M + S - 1 ticks, each hopping
    one microbatch activation block (B_local / M, S, D), and the backward
    mirrors every hop."""
    blk = ((global_batch // n_dp) // microbatches
           * cfg.max_len * cfg.d_model * _esize(cfg.dtype))
    ticks = microbatches + n_pp - 1
    return {"op": "ppermute", "logical_bytes": 2 * ticks * blk,
            "per_tick_block_bytes": blk, "ticks": ticks}


def _ep_schedule_bytes(cfg, n_dp: int, n_ep: int, global_batch: int) -> dict:
    """Per-rank wire bytes of one ep step: each MoE layer ships the
    owner-major (E_total * capacity, D) fp32 queue out and back (2
    all_to_alls forward), mirrored in the backward (4 per layer)."""
    tokens_local = (global_batch // (n_dp * n_ep)) * cfg.max_len
    capacity = max(int(cfg.capacity_factor * tokens_local
                       / cfg.num_experts), 1)
    blk = 4 * cfg.num_experts * capacity * cfg.d_model
    layers = max(int(cfg.num_layers), 1)
    return {"op": "all_to_all", "logical_bytes": 4 * layers * blk,
            "per_layer_block_bytes": blk, "layers": layers,
            "capacity": capacity}


def _tp_schedule_bytes(cfg, n_dp: int, global_batch: int) -> dict:
    """Per-rank all-reduce bytes of one tp step, the executed Megatron
    schedule: per layer the attention's and the MLP's row outputs
    forward and their column inputs' cotangents backward (4 activation
    blocks (B_local, S, D), the cost model's ``t_tp`` payload); the
    embedding's lookup forward and the head's input cotangent backward
    (one block each); the vocab-parallel cross-entropy's row maxima, sums
    of exponentials and gold logits (3 fp32 rows of B_local * S)."""
    rows = (global_batch // n_dp) * cfg.max_len
    blk = rows * cfg.d_model * _esize(cfg.dtype)
    layers = max(int(cfg.num_layers), 1)
    parts = {"layers": 4 * layers * blk, "embed": blk, "head": blk,
             "xent": 3 * rows * 4}
    return {"op": "psum", "logical_bytes": sum(parts.values()),
            "count": 4 * layers + 2 + 3, "per_layer_block_bytes": blk,
            "layers": layers, "parts": parts}


def _record_schedule(mesh, axis, sched, n_calls, dtype, family):
    from ..telemetry import events as _events
    from .collectives import axis_label, dtype_name
    _events.record_collective(
        axis_label(mesh.group(axis)), sched["logical_bytes"], n_calls, 0.0,
        wire_bytes=sched["logical_bytes"], scheme="fp32",
        dtype=dtype_name(dtype), op=sched["op"], family=family)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _sum_over(tensors, group, divide: float = 1.0):
    """Sum each tensor over ``group`` (one all-reduce of their
    concatenation) and divide by ``divide``."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if divide != 1.0:
        flat = flat / divide
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _flat_body(grads_of, opt, ddp, tokens_at, finite_group=None):
    """``body(carry, tokens)``: ``grads_of`` on this rank's block, the
    DDP reduction over ``ddp``'s group, then :func:`~apex_tpu_torch.train.
    flat_update` (its finite flag a MIN over ``finite_group`` if given)."""
    from ..train import flat_update

    def body(carry, tokens):
        params, state = carry
        loss, grads = grads_of(params, tokens_at.local(tokens))
        held = [ddp.allreduce_grads(grads)]
        del grads
        return flat_update(opt, state, params, held,
                           finite_group=finite_group), loss
    return body


def _allgather(plan):
    """The sharded update's parameter all-gather scheme (None: fp32)."""
    return None if plan.allgather_scheme == "fp32" else plan.allgather_scheme


def _leaves(params):
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    return leaves, treedef


def _check_batch(global_batch, n, what):
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide over "
                         f"the {what} ({n})")


def _metered_step(body, info, meter):
    """``step(carry, tokens)`` over ``body``; with ``meter`` the first
    call's collectives fill ``info["collectives"]``."""
    def step(carry, tokens):
        if meter and "collectives" not in info:
            with comm.recording() as tape:
                out = body(carry, tokens)
            info["collectives"] = tape
            return out
        return body(carry, tokens)
    return step


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def build_plan_step(cfg, mesh, plan, *, global_batch: int, lr: float = 1e-2,
                    amp_dtype=None, meter: bool = True, params=None,
                    seed: int = 0, device=None):
    """Materialise ``plan`` as an executable train step over ``mesh``
    (which carries the plan's axes, ``plan.axis_sizes()``: what
    :meth:`Plan.apply` builds).  Returns ``(carry0, step, info)``.

    ``params`` are the starting weights (the engine's model's tree, the
    whole model on every rank: the engines take their slices), default
    drawn from ``seed``; ``device`` defaults to ``"cuda"``.  Knobs without
    an argument here resolve through their environment surfaces, which
    :meth:`Plan.apply` sets.  ``amp_dtype`` (``"bfloat16"``: the model
    copy and activations in bf16 off the fp32 master) belongs to the tp
    engine and is ignored by the others, as in the JAX engine."""
    if plan.allgather_scheme != "fp32" and not plan.shards_update:
        raise ValueError(
            f"allgather_scheme={plan.allgather_scheme!r} needs a sharded "
            "update (update_sharding='zero1' or zero=True): a replicated "
            "update gathers no parameters")
    dev = resolve_device(device)
    args = (cfg, mesh, plan, global_batch, lr, meter, params, seed, dev)
    if plan.zero:
        return _build_zero_step(*args)
    if plan.tp > 1:
        return _build_tp_step(*args, amp_dtype=amp_dtype)
    if plan.sp > 1:
        return _build_sp_step(*args)
    if plan.pp_stages > 1:
        return _build_pp_step(*args)
    if plan.ep > 1:
        return _build_ep_step(*args)
    from . import overlap as _ov
    from ..train import build_flagship_step
    _check_batch(global_batch, mesh.shape[DATA_AXIS], "data axis")
    ov_mode = _ov.resolve_mode(None)
    ddp_kwargs = {"axis_name": mesh.group(DATA_AXIS),
                  "allgather_scheme": _allgather(plan)}
    if ov_mode != "off":
        ddp_kwargs["overlap"] = ov_mode
    carry0, fstep = build_flagship_step(cfg, ddp_kwargs=ddp_kwargs,
                                        params=params, seed=seed, lr=lr,
                                        device=dev)
    tokens_at = Placement(mesh, (DATA_AXIS,))

    def step(carry, tokens):
        return fstep(carry, tokens_at.local(tokens))

    step.ddp = fstep.ddp
    return carry0, step, {"family": plan.family, "engine": "shard_map.dp",
                          "overlap": ov_mode}


def _init_params(cfg, params, seed, dev):
    from ..models import transformer_init
    if params is not None:
        return params
    return transformer_init(cfg, torch.Generator().manual_seed(seed),
                            device=dev)


def _amp_dtype(amp_dtype):
    if amp_dtype is None or isinstance(amp_dtype, torch.dtype):
        return amp_dtype
    return getattr(torch, str(amp_dtype))


def _build_tp_step(cfg, mesh, plan, global_batch, lr, meter, params, seed,
                   dev, amp_dtype=None):
    """The tensor-parallel engine (see the module docstring).  The mesh's
    ``model`` axis (size 1 included) carries the Megatron all-reduces; a
    mesh without one runs the unsplit model."""
    from ..models.transformer import tp_shard_params, transformer_loss
    from ..optimizers import FusedAdam
    from ..train import mean_loss
    from .collectives import axis_label, dtype_name
    from .distributed import DistributedDataParallel

    n_dp = int(mesh.shape[DATA_AXIS])
    n_tp = int(mesh.shape.get(MODEL_AXIS, 1))
    _check_batch(global_batch, n_dp, "data axis")
    if cfg.num_heads % n_tp:
        raise ValueError(f"num_heads {cfg.num_heads} must divide over the "
                         f"model axis ({n_tp}) — the attention shard unit")
    if plan.collective_scheme != "fp32":
        raise ValueError(f"the tp engine's data wire is fp32 (the planner "
                         f"enumerates no other); got "
                         f"{plan.collective_scheme!r}")
    amp = _amp_dtype(amp_dtype)
    # the JAX engine's configuration: GSPMD cannot partition its Pallas
    # attention and cross-entropy, so both engines run the plain paths
    run_cfg = dataclasses.replace(cfg, attn_impl="default", xent_impl="xla")
    if amp is not None:
        run_cfg = dataclasses.replace(run_cfg, dtype=amp)
    tp_group = mesh.group(MODEL_AXIS) if MODEL_AXIS in mesh.shape else None
    tp_rank = mesh.axis_index(MODEL_AXIS) if tp_group is not None else 0
    params0 = tp_shard_params(_init_params(cfg, params, seed, dev), cfg,
                              tp_rank, n_tp)
    opt = FusedAdam(lr=lr, impl="fused")
    data_group = mesh.group(DATA_AXIS)
    ddp = DistributedDataParallel(axis_name=data_group,
                                  collective_scheme="fp32",
                                  allgather_scheme=_allgather(plan),
                                  device=dev)
    su = ddp.weight_update(opt)
    state0 = opt.init(params0) if su is None else su.init(params0)
    tokens_at = Placement(mesh, (DATA_AXIS,))

    def grads_of(params, tokens):
        leaves, treedef = _leaves(params)
        model = leaves if amp is None else [p.to(amp) for p in leaves]
        loss = transformer_loss(tree_unflatten(treedef, model),
                                {"tokens": tokens, "targets": tokens},
                                run_cfg, tp_group=tp_group)
        grads = torch.autograd.grad(loss, leaves)
        return mean_loss(loss, data_group), tree_unflatten(treedef,
                                                           list(grads))

    if su is None:
        body = _flat_body(grads_of, opt, ddp, tokens_at,
                          finite_group=mesh.world)
    else:
        def body(carry, tokens):
            params, state = carry
            loss, grads = grads_of(params, tokens_at.local(tokens))
            return su.step(state, grads, params,
                           finite_group=mesh.world), loss

    info = {"family": plan.family, "engine": "megatron", "tp": n_tp,
            "dp": n_dp,
            "flat_world": n_tp * (n_dp if plan.shards_update else 1),
            "amp_dtype": None if amp is None else dtype_name(amp)}
    if meter:
        info["tp_wire"] = _tp_schedule_bytes(run_cfg, n_dp, global_batch)
    inner = _metered_step(body, info, meter)

    def step(carry, tokens):
        out = inner(carry, tokens)
        if meter and "metered" not in info:
            from ..telemetry import events as _events
            agg = dict(info["collectives"].get(
                "all-reduce", {"count": 0, "logical_bytes": 0}))
            _events.record_collective(
                axis_label(tp_group), agg["logical_bytes"], agg["count"],
                0.0, wire_bytes=agg["logical_bytes"], scheme="fp32",
                dtype=dtype_name(run_cfg.dtype), op="psum", family="tp")
            info["metered"] = {"all-reduce": agg}
        return out

    step.grads_of = lambda params, tokens: grads_of(params,
                                                    tokens_at.local(tokens))
    step.cfg = run_cfg
    return (params0, state0), step, info


def _build_sp_step(cfg, mesh, plan, global_batch, lr, meter, params, seed,
                   dev):
    """The sequence-parallel engine (see the module docstring)."""
    from ..models import transformer_loss
    from ..optimizers import FusedAdam
    from ..train import mean_loss
    from .distributed import DistributedDataParallel
    from .sequence import ring_attention, ulysses_attention, validate_sp

    n_dp = int(mesh.shape[DATA_AXIS])
    n_sp = int(mesh.shape.get(SEQ_AXIS, 1))
    strategy = plan.sp_strategy if plan.sp_strategy != "none" else "ring"
    validate_sp(cfg.max_len, cfg.num_heads, n_sp, strategy)
    _check_batch(global_batch, n_dp, "data axis")
    s_local = cfg.max_len // n_sp
    seq_group, world = mesh.group(SEQ_AXIS), mesh.world

    params0 = _init_params(cfg, params, seed, dev)
    opt = FusedAdam(lr=lr, impl="fused")
    ddp = DistributedDataParallel(axis_name=mesh.group(DATA_AXIS),
                                  allgather_scheme=_allgather(plan),
                                  device=dev)
    su = ddp.weight_update(opt)
    seq_fn = ulysses_attention if strategy == "ulysses" else ring_attention

    def attn(q, k, v, *, causal):
        return seq_fn(q, k, v, axis_name=seq_group, causal=causal)

    off = mesh.axis_index(SEQ_AXIS) * s_local
    tokens_at = Placement(mesh, (DATA_AXIS, SEQ_AXIS))

    def grads_of(params, tokens):
        leaves, treedef = _leaves(params)
        loss = transformer_loss(tree_unflatten(treedef, leaves),
                                {"tokens": tokens, "targets": tokens}, cfg,
                                attn_override=attn, pos_offset=off)
        grads = torch.autograd.grad(loss, leaves)
        # each rank's gradients cover only its sequence block's loss
        # terms: the sum over seq / n_sp is the seq mean, so the dp
        # reduction below needs no extra scaling
        grads = _sum_over(list(grads), seq_group, float(n_sp))
        return mean_loss(loss, world), tree_unflatten(treedef, grads)

    state0 = opt.init(params0) if su is None else su.init(params0)

    def zero1_body(carry, tokens):
        params, state = carry
        loss, grads = grads_of(params, tokens_at.local(tokens))
        return su.step(state, grads, params), loss

    body = (_flat_body(grads_of, opt, ddp, tokens_at) if su is None
            else zero1_body)

    info = {"family": plan.family, "engine": f"shard_map.sp.{strategy}",
            "dp": n_dp, "sp": n_sp}
    if meter:
        sched = _sp_schedule_bytes(cfg, strategy, n_dp, n_sp, global_batch)
        info["sp_wire"] = sched
        _record_schedule(mesh, SEQ_AXIS, sched, sched["layers"], cfg.dtype,
                         "sp")
    step = _metered_step(body, info, meter)
    step.grads_of = lambda params, tokens: grads_of(params,
                                                    tokens_at.local(tokens))
    return (params0, state0), step, info


def _build_pp_step(cfg, mesh, plan, global_batch, lr, meter, params, seed,
                   dev):
    """The pipeline-parallel engine (see the module docstring)."""
    from ..contrib.xentropy import softmax_xentropy_loss
    from ..models.transformer import block, embed, head
    from ..optimizers import FusedAdam
    from ..telemetry import goodput as _goodput
    from ..train import mean_loss
    from .distributed import DistributedDataParallel
    from .pipeline import PIPE_AXIS, pipeline_apply

    n_dp = int(mesh.shape[DATA_AXIS])
    n_pp = int(mesh.shape.get(PIPE_AXIS, 1))
    m_micro = max(int(plan.pp_microbatches), 1)
    n_layers = int(cfg.num_layers)
    if n_pp <= 1:
        raise ValueError("pp plan needs a pipe mesh axis of size >= 2")
    if n_layers % n_pp:
        raise ValueError(f"num_layers {n_layers} must divide into "
                         f"{n_pp} pipeline stages")
    _check_batch(global_batch, n_dp, "data axis")
    b_local = global_batch // n_dp
    if b_local % m_micro:
        raise ValueError(f"per-replica batch {b_local} must divide into "
                         f"{m_micro} microbatches")
    if plan.shards_update or plan.zero:
        raise ValueError("the pp engine runs the plain fused-flat update "
                         "(no zero/zero1 composition)")
    l_local = n_layers // n_pp
    stage = mesh.axis_index(PIPE_AXIS)
    pipe_group = mesh.group(PIPE_AXIS)
    last = stage == n_pp - 1

    full = _init_params(cfg, params, seed, dev)
    # this rank's contiguous layer slice, in order
    params0 = dict(full)
    params0["layers"] = {k: v[stage * l_local:(stage + 1) * l_local].clone()
                         for k, v in full["layers"].items()}
    opt = FusedAdam(lr=lr, impl="fused")
    ddp = DistributedDataParallel(axis_name=mesh.group(DATA_AXIS),
                                  device=dev)
    state0 = opt.init(params0)

    def stage_fn(lp, h):
        for i in range(l_local):
            h = block(h, {k: v[i] for k, v in lp.items()}, cfg)
        return h

    def local_loss(p, tokens):
        S = tokens.shape[1]
        x = embed(p, tokens, p["embed"]["pos"][:S][None], cfg)
        xm = x.reshape(m_micro, b_local // m_micro, S, cfg.d_model)
        out = pipeline_apply(stage_fn, p["layers"], xm, axis_name=pipe_group)
        x = out.reshape(b_local, S, cfg.d_model)
        # head and loss masked to the last stage: every stage holds the
        # replicated outputs, and an unmasked head would count the tied
        # embedding's logit gradient once per stage
        is_last = torch.tensor(last, device=x.device)
        x = torch.where(is_last, x, torch.zeros_like(x))
        logits = head(p, x, cfg)
        V = logits.shape[-1]
        nll = softmax_xentropy_loss(logits.reshape(-1, V),
                                    tokens.reshape(-1), 0.0, -1, False,
                                    cfg.xent_impl)
        return torch.where(is_last, nll.mean(), torch.zeros_like(nll[0]))

    tokens_at = Placement(mesh, (DATA_AXIS,))

    def grads_of(params, tokens):
        leaves, treedef = _leaves(params)
        loss = local_loss(tree_unflatten(treedef, leaves), tokens)
        grads = tree_unflatten(treedef,
                               list(torch.autograd.grad(loss, leaves)))
        # embed / head gradients are stage-masked partials (the injection
        # on stage 0, the tied head on the last): one sum over pipe
        # reassembles each once; a stage's layer gradients are its own
        for k in ("embed", "head"):
            ks = sorted(grads[k])
            summed = _sum_over([grads[k][n] for n in ks], pipe_group)
            grads[k] = dict(zip(ks, summed))
        loss = loss.detach().to(torch.float32).clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=pipe_group)
        return mean_loss(loss, mesh.group(DATA_AXIS)), grads

    body = _flat_body(grads_of, opt, ddp, tokens_at)

    ticks = m_micro + n_pp - 1
    info = {"family": plan.family, "engine": "shard_map.pp",
            "dp": n_dp, "pp": n_pp, "microbatches": m_micro,
            "stages_layers": l_local,
            "pipeline_bubble_fraction": (n_pp - 1) / ticks}
    led = _goodput.get_ledger()
    if led is not None:
        led.set_pipeline_bubble(info["pipeline_bubble_fraction"])
    if meter:
        sched = _pp_schedule_bytes(cfg, n_dp, n_pp, m_micro, global_batch)
        info["pp_wire"] = sched
        _record_schedule(mesh, PIPE_AXIS, sched, 2 * sched["ticks"],
                         cfg.dtype, "pp")
    step = _metered_step(body, info, meter)
    step.grads_of = lambda params, tokens: grads_of(params,
                                                    tokens_at.local(tokens))
    return (params0, state0), step, info


def _moe_cfg_from(cfg, n_ep: int):
    """The MoE variant an ep plan materialises: the dense config's dims
    with ``EP_DEFAULT_EXPERTS`` switch experts (rounded up to a multiple
    of the expert-axis width); MoE configs pass through untouched."""
    from ..models.moe_transformer import MoETransformerConfig
    from .plan import EP_DEFAULT_EXPERTS
    if isinstance(cfg, MoETransformerConfig):
        return cfg
    experts = max(EP_DEFAULT_EXPERTS, n_ep)
    if experts % n_ep:
        experts = n_ep * (experts // n_ep + 1)
    return MoETransformerConfig(
        vocab_size=cfg.vocab_size, max_len=cfg.max_len,
        num_layers=cfg.num_layers, d_model=cfg.d_model,
        num_heads=cfg.num_heads, d_ff=cfg.d_ff, num_experts=experts,
        causal=cfg.causal, dtype=cfg.dtype,
        xent_impl=getattr(cfg, "xent_impl", "auto"))


def _is_expert_leaf(path) -> bool:
    """The expert-sharded leaves of the MoE tree: each layer's ``w_in`` /
    ``w_out`` stacks (leading expert axis); the router is dense."""
    return bool(path) and path[-1] in ("w_in", "w_out")


def _build_ep_step(cfg, mesh, plan, global_batch, lr, meter, params, seed,
                   dev):
    """The expert-parallel engine (see the module docstring)."""
    from ..models.moe_transformer import (moe_transformer_init,
                                          moe_transformer_loss)
    from ..optimizers import FusedAdam
    from ..train import mean_loss
    from .distributed import DistributedDataParallel
    from .expert import EXPERT_AXIS

    n_dp = int(mesh.shape[DATA_AXIS])
    n_ep = int(mesh.shape.get(EXPERT_AXIS, 1))
    cfg_moe = _moe_cfg_from(cfg, max(n_ep, 1))
    if cfg_moe.num_experts % max(n_ep, 1):
        raise ValueError(f"{cfg_moe.num_experts} experts must divide over "
                         f"the expert axis ({n_ep})")
    _check_batch(global_batch, n_dp * n_ep, "data x expert axes")
    if plan.shards_update or plan.zero:
        raise ValueError("the ep engine runs the plain fused-flat update "
                         "(no zero/zero1 composition)")

    full = params if params is not None else moe_transformer_init(
        cfg_moe, torch.Generator().manual_seed(seed), device=dev)
    e_local = cfg_moe.num_experts // max(n_ep, 1)
    if n_ep > 1:
        e0 = mesh.axis_index(EXPERT_AXIS) * e_local
        params0 = tree_map_with_path(
            lambda path, l: (l[e0:e0 + e_local].clone()
                             if _is_expert_leaf(path) else l), full)
        expert_group = mesh.group(EXPERT_AXIS)
        tokens_at = Placement(mesh, ((DATA_AXIS, EXPERT_AXIS),))
    else:
        params0, expert_group = full, None
        tokens_at = Placement(mesh, (DATA_AXIS,))
    opt = FusedAdam(lr=lr, impl="fused")
    ddp = DistributedDataParallel(axis_name=mesh.group(DATA_AXIS),
                                  device=dev)
    state0 = opt.init(params0)
    expert_ids = {i for i, (path, _) in enumerate(
        tree_leaves_with_path(params0)) if _is_expert_leaf(path)}

    def grads_of(params, tokens):
        leaves, treedef = _leaves(params)
        loss = moe_transformer_loss(tree_unflatten(treedef, leaves),
                                    {"tokens": tokens, "targets": tokens},
                                    cfg_moe, expert_axis=expert_group)
        grads = list(torch.autograd.grad(loss, leaves))
        if n_ep > 1:
            # dense leaves: the sum over expert / n_ep is the mean of the
            # shards' gradients; expert leaves already hold every peer's
            # part (the backward exchange brought it) and take the mean's
            # division only
            dense = [i for i in range(len(grads)) if i not in expert_ids]
            summed = _sum_over([grads[i] for i in dense], expert_group,
                               float(n_ep))
            for i, g in zip(dense, summed):
                grads[i] = g
            for i in expert_ids:
                grads[i] = grads[i] / n_ep
        return mean_loss(loss, mesh.world), tree_unflatten(treedef, grads)

    body = _flat_body(grads_of, opt, ddp, tokens_at)

    info = {"family": plan.family, "engine": "shard_map.ep",
            "dp": n_dp, "ep": n_ep, "experts": cfg_moe.num_experts,
            "capacity_factor": cfg_moe.capacity_factor}
    if meter and n_ep > 1:
        info["ep_wire"] = _ep_schedule_bytes(cfg_moe, n_dp, n_ep,
                                             global_batch)
    inner = _metered_step(body, info, meter)

    def step(carry, tokens):
        out = inner(carry, tokens)
        if meter and n_ep > 1 and "metered" not in info:
            info["metered"] = {k: dict(v) for k, v in
                               info["collectives"].items()
                               if k == "all-to-all"}
        return out

    step.grads_of = lambda params, tokens: grads_of(params,
                                                    tokens_at.local(tokens))
    step.cfg = cfg_moe
    return (params0, state0), step, info


def _build_zero_step(cfg, mesh, plan, global_batch, lr, meter, params, seed,
                     dev):
    """The contrib-ZeRO engine: ``DistributedFusedAdam`` over ``data``
    (permanently sharded state, the reduce-scatter / all-gather wire on
    the plan's collective scheme, which :meth:`Plan.apply` sets)."""
    from ..contrib.optimizers import DistributedFusedAdam
    from ..train import zero_train_step

    n_dp = int(mesh.shape[DATA_AXIS])
    _check_batch(global_batch, n_dp, "data axis")
    params0 = _init_params(cfg, params, seed, dev)
    opt = DistributedFusedAdam(lr=lr, shard_group=mesh.group(DATA_AXIS),
                               impl="xla", allgather_scheme=_allgather(plan))
    state0 = opt.init(params0)
    tokens_at = Placement(mesh, (DATA_AXIS,))

    def body(carry, tokens):
        params, state = carry
        toks = tokens_at.local(tokens)
        params, state, loss = zero_train_step(
            params, state, {"tokens": toks, "targets": toks}, cfg, opt)
        return (params, state), loss

    info = {"family": plan.family, "engine": "shard_map.zero", "dp": n_dp}
    return (params0, state0), _metered_step(body, info, meter), info
