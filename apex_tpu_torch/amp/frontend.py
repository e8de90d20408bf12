"""amp frontend: ``initialize``, ``scale_loss``, ``amp_step``.

Counterpart of ``apex_tpu/amp/frontend.py``.  ``initialize`` takes the
model's fp32 parameter tree and a fused optimizer and returns an
:class:`AmpState`: the parameters cast per opt level, fp32 masters (or, with
a fused flat optimizer, none: the optimizer's flat buffer is the master),
one loss scaler per loss, and the optimizer state.  :func:`amp_step` is the
post-backward pipeline: unscale -> overflow check -> optimizer step on the
masters -> skip-step select -> scaler update -> model-precision copy.

O1 and O4 turn on the per-op casts of :mod:`.amp` (fp16 and bf16
respectively) for the calling thread, as the JAX package patches its
namespaces; ``amp.uninit()`` turns them off.  Lists of models and
optimizers give a list of states.  :func:`add_param_group` extends the
trained tree mid-run, and :func:`state_dict` / :func:`load_state_dict`
carry the loss scalers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from . import amp as _amp
from . import scaler as _scaler
from .properties import Properties, opt_levels
from ..telemetry import trace as _trace
from ..utils import pytree as _pt

__all__ = ["AmpState", "initialize", "scale_loss", "amp_step",
           "amp_step_multi", "add_param_group", "master_params",
           "state_dict", "load_state_dict"]


@dataclasses.dataclass(frozen=True)
class AmpState:
    model_params: Any               # cast params
    master_params: Any              # fp32 masters, or None
    scalers: Tuple[_scaler.ScalerState, ...]
    opt_state: Any                  # optimizer state, or None
    properties: Any = None
    optimizer: Any = None
    cast_model_outputs: Any = None

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def loss_scale(self):
        return self.scalers[0].loss_scale

    def cast_input(self, x):
        """Floating tensors of ``x`` (a tree) in the opt level's model
        dtype; unchanged where the level casts no model (O1, O4)."""
        return _cast_floats(x, self.properties.cast_model_type)

    def cast_output(self, y):
        """Floating tensors of ``y`` in the ``cast_model_outputs`` dtype
        given to :func:`initialize`; unchanged without one."""
        return _cast_floats(y, self.cast_model_outputs)

    def params_for_eval(self):
        """fp32 view of the parameters."""
        if _flat_masters_active(self):
            return _master_flattener(self).unflatten(self.opt_state.master)
        src = self.master_params if self.master_params is not None \
            else self.model_params
        return _pt.tree_map(lambda p: p.float() if _pt.is_float(p) else p,
                            src)


def _cast_floats(tree, dt):
    """Floating tensors of ``tree`` cast to ``dt`` (None / False: no-op);
    Python scalars and integer tensors pass through."""
    if dt in (None, False):
        return tree
    args, _ = _pt.cast_inputs((tree,), {}, dt)
    return args[0]


def initialize(params, optimizer=None, opt_level="O1", *, num_losses=1,
               verbosity=1, cast_model_type=None, patch_functions=None,
               keep_batchnorm_fp32=None, master_weights=None,
               loss_scale=None, min_loss_scale=1.0,
               max_loss_scale=2.0 ** 24,
               allow_incoming_model_not_fp32=False,
               cast_model_outputs=None,
               flash_attn_backward=None) -> "AmpState | list[AmpState]":
    """Opt-level driven setup.  ``params``: fp32 parameter tree (on the
    device the model runs on; the scalers go there too).  ``optimizer``: a
    fused optimizer, whose state is made against the masters.  Keyword
    overrides apply after the preset.  O1 / O4 turn the casts of
    :mod:`.amp` on in the calling thread.

    A list (or tuple) of parameter trees with a list of optimizers of the
    same length gives a list of independent states, paired by position;
    a list of trees with one optimizer is one model."""
    if isinstance(params, (list, tuple)) \
            and isinstance(optimizer, (list, tuple)):
        opts = list(optimizer)
        if len(opts) != len(params):
            raise ValueError(
                f"{len(params)} models but {len(opts)} optimizers")
        kw = dict(num_losses=num_losses, verbosity=verbosity,
                  cast_model_type=cast_model_type,
                  patch_functions=patch_functions,
                  keep_batchnorm_fp32=keep_batchnorm_fp32,
                  master_weights=master_weights, loss_scale=loss_scale,
                  min_loss_scale=min_loss_scale,
                  max_loss_scale=max_loss_scale,
                  allow_incoming_model_not_fp32=allow_incoming_model_not_fp32,
                  cast_model_outputs=cast_model_outputs,
                  flash_attn_backward=flash_attn_backward)
        return [initialize(p, o, opt_level, **kw)
                for p, o in zip(params, opts)]

    if opt_level not in opt_levels:
        raise RuntimeError(f"Unexpected optimization level {opt_level}; "
                           "options are 'O0'..'O5'.")
    props = opt_levels[opt_level](Properties())
    for name, val in (("cast_model_type", cast_model_type),
                      ("patch_functions", patch_functions),
                      ("keep_batchnorm_fp32", keep_batchnorm_fp32),
                      ("master_weights", master_weights),
                      ("loss_scale", loss_scale),
                      ("flash_attn_backward", flash_attn_backward)):
        if val is not None:
            setattr(props, name, val)
    if verbosity:
        print(f"apex_tpu_torch.amp: opt_level {opt_level} -> {props}")

    from ..contrib.multihead_attn import flash as _flash
    _flash.set_default_backward(props.flash_attn_backward)

    leaves = _pt.tree_leaves_with_path(params)
    if not leaves:
        raise ValueError("amp.initialize needs at least one parameter")
    if not allow_incoming_model_not_fp32:
        offending = [_pt.path_str(p) for p, leaf in leaves
                     if _pt.is_float(leaf) and leaf.dtype != torch.float32]
        if offending:
            raise RuntimeError(
                "Found param(s) that are not fp32: "
                f"{offending[:8]}{'...' if len(offending) > 8 else ''}. "
                "amp.initialize expects an fp32 model (it applies the "
                "opt_level's cast itself); pass "
                "allow_incoming_model_not_fp32=True if this is intended.")
    device = leaves[0][1].device

    model_params = params
    ct = props.cast_model_type
    if ct not in (None, False) and ct != torch.float32:
        model_params = _pt.convert_network(
            params, ct, keep_batchnorm_fp32=bool(props.keep_batchnorm_fp32))
    elif ct not in (None, False):
        model_params = _pt.cast_tree(params, torch.float32)

    masters = _pt.master_params_from(params) if props.master_weights \
        else None

    scalers = tuple(
        _scaler.init(props.loss_scale, min_loss_scale=min_loss_scale,
                     max_loss_scale=max_loss_scale, device=device)
        for _ in range(num_losses))

    if props.patch_functions and props.patch_functions_type is not None:
        _amp.init(patch_type=props.patch_functions_type)

    opt_state = None
    if optimizer is not None:
        target = masters if masters is not None else model_params
        opt_state = optimizer.init(target)
        if (masters is not None and _is_fused_flat(optimizer)
                and getattr(opt_state, "master", None) is not None):
            # the fused state's flat buffer is the master: a second tree
            # copy would double master memory
            masters = None

    return AmpState(model_params=model_params, master_params=masters,
                    scalers=scalers, opt_state=opt_state, properties=props,
                    optimizer=optimizer,
                    cast_model_outputs=cast_model_outputs)


def _is_fused_flat(optimizer) -> bool:
    return getattr(optimizer, "impl", None) == "fused"


def _flat_masters_active(amp_state: AmpState) -> bool:
    """True when the masters live flat inside the fused optimizer state."""
    return (amp_state.master_params is None
            and amp_state.optimizer is not None
            and _is_fused_flat(amp_state.optimizer)
            and bool(amp_state.properties is not None
                     and amp_state.properties.master_weights)
            and getattr(amp_state.opt_state, "master", None) is not None)


def _master_flattener(amp_state: AmpState):
    """Packing plan of the fp32 master layout (the model tree's structure
    and shapes, fp32), from shape-only ``meta`` tensors."""
    ref = _pt.tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"),
                       amp_state.model_params)
    return amp_state.optimizer.flattener_for(ref)


def scale_loss(loss, amp_state: AmpState, loss_id: int = 0):
    """loss * the current scale of scaler ``loss_id``."""
    return _scaler.scale_loss(amp_state.scalers[loss_id], loss)


def amp_step(amp_state: AmpState, grads, *, loss_id: int = 0, lr=None):
    """The post-backward pipeline for one loss; returns a new AmpState."""
    return amp_step_multi(amp_state, [(grads, loss_id)], lr=lr)


def amp_step_multi(amp_state: AmpState, grads_and_ids, *, lr=None):
    """Several backward passes, each scaled by its own scaler, accumulated
    into one optimizer step; skipped if any overflowed."""
    if amp_state.optimizer is None:
        raise RuntimeError("amp_step_multi requires an optimizer passed to "
                           "initialize()")
    with _trace.span("amp.step"):
        with _trace.span("amp.unscale"):
            total32 = None
            finites = {}
            for grads, loss_id in grads_and_ids:
                g32, finite = _scaler.unscale(amp_state.scalers[loss_id],
                                              grads)
                finites[loss_id] = (finites[loss_id] & finite
                                    if loss_id in finites else finite)
                total32 = g32 if total32 is None else _pt.tree_map(
                    torch.add, total32, g32)
            all_finite = None
            for f in finites.values():
                all_finite = f if all_finite is None else (all_finite & f)
            scalers = tuple(
                _scaler.update(s, finites[i]) if i in finites else s
                for i, s in enumerate(amp_state.scalers))

        if _flat_masters_active(amp_state):
            # flat fast path: pack the grads once, update the flat master,
            # one unflatten-with-cast gives the model copy
            opt = amp_state.optimizer
            fl = _master_flattener(amp_state)
            with _trace.span("amp.flatten"):
                flat = fl.flatten(total32)
            with _trace.span("amp.optimizer"):
                new_opt_state = opt.step_flat(amp_state.opt_state, flat,
                                              lr=lr)
            del flat
            with _trace.span("amp.select"):
                new_opt_state = _scaler.apply_if_finite(
                    all_finite, new_opt_state, amp_state.opt_state)
            with _trace.span("amp.model_copy"):
                model_params = fl.unflatten(new_opt_state.master,
                                            like=amp_state.model_params)
            return amp_state._replace(model_params=model_params,
                                      scalers=scalers,
                                      opt_state=new_opt_state)

        masters = (amp_state.master_params
                   if amp_state.master_params is not None
                   else amp_state.model_params)
        with _trace.span("amp.optimizer"):
            new_masters, new_opt_state = amp_state.optimizer.step(
                amp_state.opt_state, total32, masters, lr=lr)
        with _trace.span("amp.select"):
            new_masters = _scaler.apply_if_finite(all_finite, new_masters,
                                                  masters)
            new_opt_state = _scaler.apply_if_finite(all_finite,
                                                    new_opt_state,
                                                    amp_state.opt_state)
        if amp_state.master_params is not None:
            with _trace.span("amp.model_copy"):
                model_params = _pt.master_to_model(new_masters,
                                                   amp_state.model_params)
            return amp_state._replace(model_params=model_params,
                                      master_params=new_masters,
                                      scalers=scalers,
                                      opt_state=new_opt_state)
        return amp_state._replace(model_params=new_masters, scalers=scalers,
                                  opt_state=new_opt_state)


def master_params(amp_state: AmpState):
    """The master (fp32) parameters, as a list of leaves."""
    if _flat_masters_active(amp_state):
        return _pt.tree_leaves(_master_flattener(amp_state).unflatten(
            amp_state.opt_state.master))
    src = (amp_state.master_params if amp_state.master_params is not None
           else amp_state.model_params)
    return _pt.tree_leaves(src)


def add_param_group(amp_state: AmpState, new_params):
    """Extend the trained parameters mid-run: ``new_params`` (an fp32 dict
    whose top-level keys the model's dict does not hold) merges into the
    model.  Existing leaves keep their master values, optimizer moments
    and the step count; new leaves get the preset's casts and masters and
    zero moments; the scalers carry over.  Both impls: the flat engine
    repacks its buffers into the merged layout once."""
    props = amp_state.properties
    opt = amp_state.optimizer
    old32 = amp_state.params_for_eval()
    if not (isinstance(old32, dict) and isinstance(new_params, dict)):
        raise TypeError("add_param_group needs dict param trees "
                        "(merge = new top-level keys)")
    overlap = set(old32) & set(new_params)
    if overlap:
        raise ValueError(f"new param group re-uses existing keys: "
                         f"{sorted(overlap)}")
    merged32 = {**old32, **new_params}

    fresh = initialize(
        merged32, opt, opt_level=props.opt_level,
        num_losses=len(amp_state.scalers), verbosity=0,
        cast_model_type=props.cast_model_type,
        patch_functions=props.patch_functions,
        keep_batchnorm_fp32=props.keep_batchnorm_fp32,
        master_weights=props.master_weights,
        loss_scale=props.loss_scale,
        flash_attn_backward=props.flash_attn_backward,
        cast_model_outputs=amp_state.cast_model_outputs)

    new_opt_state = fresh.opt_state
    if amp_state.opt_state is not None and new_opt_state is not None:
        if _is_fused_flat(opt):
            new_opt_state = _migrate_flat_state(amp_state, fresh, old32,
                                                merged32)
        else:
            merged_fields = {}
            for field in new_opt_state._fields:
                old_v = getattr(amp_state.opt_state, field)
                fresh_v = getattr(new_opt_state, field)
                if isinstance(old_v, dict) and isinstance(fresh_v, dict) \
                        and set(old_v) <= set(fresh_v):
                    merged_fields[field] = {**fresh_v, **old_v}
                elif _same_shape(old_v, fresh_v):
                    merged_fields[field] = old_v      # the step count
                else:
                    merged_fields[field] = fresh_v
            new_opt_state = type(new_opt_state)(**merged_fields)

    return fresh._replace(opt_state=new_opt_state,
                          scalers=amp_state.scalers)


def _same_shape(a, b) -> bool:
    return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
        and a.shape == b.shape


def _meta_f32(tree):
    return _pt.tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                              device="meta"), tree)


def _migrate_flat_state(amp_state, fresh, old32, merged32):
    """The old flat buffers (moments, master) scattered into the merged
    layout: unflattened by the old plan, laid over the fresh tree,
    flattened by the new plan.  The step count carries."""
    opt = amp_state.optimizer
    old_fl = opt.flattener_for(_meta_f32(old32))
    # the optimizer caches one plan: take the old trees before the new one
    old_trees = {}
    for field in amp_state.opt_state._fields:
        v = getattr(amp_state.opt_state, field)
        if isinstance(v, torch.Tensor) and v.dim() == 1 \
                and v.shape[0] == old_fl.total:
            old_trees[field] = old_fl.unflatten(v, dtype=torch.float32)
    new_fl = opt.flattener_for(_meta_f32(merged32))
    merged_fields = {}
    for field in fresh.opt_state._fields:
        fresh_v = getattr(fresh.opt_state, field)
        old_v = getattr(amp_state.opt_state, field)
        if field in old_trees and isinstance(fresh_v, torch.Tensor) \
                and fresh_v.dim() == 1 and fresh_v.shape[0] == new_fl.total:
            fresh_tree = new_fl.unflatten(fresh_v, dtype=torch.float32)
            merged_fields[field] = new_fl.flatten(
                {**fresh_tree, **old_trees[field]}).to(fresh_v.dtype)
        elif _same_shape(old_v, fresh_v):
            merged_fields[field] = old_v              # the step count
        else:
            merged_fields[field] = fresh_v
    return type(fresh.opt_state)(**merged_fields)


def state_dict(amp_state: AmpState) -> dict:
    """Every loss scaler as plain Python values (``amp.state_dict``)."""
    return {f"loss_scaler{i}": _scaler.state_dict(s)
            for i, s in enumerate(amp_state.scalers)}


def load_state_dict(amp_state: AmpState, d: dict) -> AmpState:
    """The scalers of :func:`state_dict` back into ``amp_state``, on the
    device of its scalers; with a different count of scalers it warns and
    loads as many as both have."""
    if len(d) != len(amp_state.scalers):
        print(f"Warning: loading state with {len(d)} scalers into "
              f"{len(amp_state.scalers)}")
    scalers = list(amp_state.scalers)
    for i in range(min(len(d), len(scalers))):
        scalers[i] = _scaler.load_state_dict(
            d[f"loss_scaler{i}"], device=scalers[i].loss_scale.device)
    return amp_state._replace(scalers=tuple(scalers))
