"""Expert parallelism: switch-MoE expert sharding and all-to-all token
routing.

Counterpart of ``apex_tpu/parallel/expert.py``: top-1 routing with a
fixed per-expert capacity (static shapes), dispatch and combine as dense
one-hot products, experts sharded over the ``expert`` group (each rank owns
``E / n`` experts' FFN weights), and two ``all_to_all`` exchanges that send
each expert's token queue to its owner and the outputs back.  Tokens past
an expert's capacity pass through with zero expert output; the router's
softmax probability scales the output, so gradients train it.

:func:`moe_ffn` runs over the ``expert`` group when its axis is bound
(an axis of the ambient mesh, or a process group passed as ``axis_name``)
and degrades to single-device MoE otherwise.  Both exchanges are
differentiable (:func:`~apex_tpu_torch.parallel.comm.all_to_all`), and
each one, forward and backward, records its bytes through
:func:`~apex_tpu_torch.telemetry.events.record_collective` (family ``ep``,
op ``all_to_all``) — where the JAX package reads the exchanges from the
compiled program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import comm
from .mesh import axis_is_bound, group_size, resolve_group

__all__ = ["EXPERT_AXIS", "moe_ffn", "MoELayer"]

EXPERT_AXIS = "expert"


def _one_hot_dispatch(logits, n_experts, capacity):
    """Token -> (expert, slot) assignment as dense one-hot tensors.

    logits (T, E).  Returns (dispatch (T, E, C) fp32 of 0/1, combine
    (T, E, C) fp32 carrying the router probability, the load-balancing
    aux loss)."""
    T, E = logits.shape
    if E != n_experts:
        raise ValueError(
            f"router width {E} != expert count {n_experts} "
            "(w_in leading dim x expert-axis size)")
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)                    # (T,) top-1, first max
    onehot = torch.nn.functional.one_hot(expert, E).float()
    # position of each token within its expert's queue (prefix count)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0  # (T, E), -1 elsewhere
    in_cap = (pos >= 0) & (pos < capacity)
    # jax.nn.one_hot gives an all-zero row for an out-of-range index
    slot_idx = pos.long()
    valid = (slot_idx >= 0) & (slot_idx < capacity)
    slot = torch.nn.functional.one_hot(
        torch.where(valid, slot_idx, torch.zeros_like(slot_idx)),
        capacity).float() * valid[..., None].float()
    dispatch = slot * in_cap[..., None].float()
    gate = (probs * onehot).sum(dim=-1)              # (T,) chosen prob
    combine = dispatch * gate[:, None, None]
    # switch-transformer load balancing: E * sum_e f_e * p_e
    frac_tokens = onehot.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = E * (frac_tokens * frac_probs).sum()
    return dispatch, combine, aux


def _bound_group(axis_name):
    """The expert group when ``axis_name`` is bound, else None."""
    if axis_name is None:
        return None
    if isinstance(axis_name, str):
        return resolve_group(axis_name) if axis_is_bound(axis_name) else None
    return resolve_group(axis_name)


def moe_ffn(x, router_w, w_in, w_out, *, axis_name=EXPERT_AXIS,
            capacity_factor: float = 1.25):
    """Top-1 MoE FFN over (T, D) tokens.  ``router_w`` (D, E_total);
    ``w_in`` (E_local, D, F), ``w_out`` (E_local, F, D) — this rank's
    experts when the axis is bound (E_total = E_local * n), all of them
    otherwise.  Returns (out (T, D), aux_loss)."""
    T, D = x.shape
    e_local = w_in.shape[0]
    group = _bound_group(axis_name)
    n = group_size(group) if group is not None else 1
    e_total = e_local * n
    capacity = max(int(capacity_factor * T / e_total), 1)

    logits = x.float() @ router_w.float()
    dispatch, combine, aux = _one_hot_dispatch(logits, e_total, capacity)
    # (T, E, C) x (T, D) -> (E, C, D): the expert queues
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())

    if group is not None:
        # owner-major (E_total, C, D) -> for every source rank, the
        # (e_local, C, D) queues bound for this rank's experts
        exchanged = comm.all_to_all(expert_in.reshape(e_total * capacity, D),
                                    group, 0, 0, meter="ep")
        expert_in = exchanged.reshape(n, e_local, capacity, D).movedim(
            0, 1).reshape(e_local, n * capacity, D)

    h = torch.relu(torch.einsum("ecd,edf->ecf", expert_in, w_in.float()))
    expert_out = torch.einsum("ecf,efd->ecd", h, w_out.float())

    if group is not None:
        expert_out = expert_out.reshape(e_local, n, capacity, D).movedim(
            1, 0)
        expert_out = comm.all_to_all(
            expert_out.reshape(e_total * capacity, D), group, 0, 0,
            meter="ep").reshape(e_total, capacity, D)

    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.to(x.dtype), aux


@dataclasses.dataclass
class MoELayer:
    """``init(generator) -> params``, ``apply(params, x)``.
    ``num_experts`` is the global count; with ``n_shards`` expert shards
    each rank holds ``num_experts / n_shards`` experts."""
    d_model: int
    d_ff: int
    num_experts: int
    n_shards: int = 1
    capacity_factor: float = 1.25
    axis_name: Optional[str] = EXPERT_AXIS

    def init(self, generator: torch.Generator, device=None):
        """Random parameters drawn on the CPU from ``generator`` (router
        normal * 0.02, experts He-scaled normals), moved to ``device``
        (default ``"cuda"``)."""
        from ..utils.device import resolve_device
        if self.num_experts % self.n_shards:
            raise ValueError(f"{self.num_experts} experts must divide over "
                             f"{self.n_shards} shards")
        dev = resolve_device(device)
        e_local = self.num_experts // self.n_shards
        s_in = math.sqrt(2.0 / self.d_model)
        s_out = math.sqrt(1.0 / self.d_ff)

        def normal(*shape):
            return torch.randn(*shape, generator=generator)
        return {
            "router": (0.02 * normal(self.d_model, self.num_experts)).to(dev),
            "w_in": (s_in * normal(e_local, self.d_model, self.d_ff)).to(dev),
            "w_out": (s_out * normal(e_local, self.d_ff,
                                     self.d_model)).to(dev),
        }

    def apply(self, params, x):
        """x (..., D) -> (out (..., D), aux_loss)."""
        lead = x.shape[:-1]
        out, aux = moe_ffn(x.reshape(-1, self.d_model), params["router"],
                           params["w_in"], params["w_out"],
                           axis_name=self.axis_name,
                           capacity_factor=self.capacity_factor)
        return out.reshape(*lead, self.d_model), aux

    __call__ = apply
