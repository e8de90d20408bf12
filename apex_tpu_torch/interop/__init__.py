"""The fused optimizers driven from a plain ``torch.nn.Module`` loop.

Counterpart of ``apex_tpu/interop/__init__.py``.  The JAX package bridges a
torch training loop to its JAX optimizers through DLPack; here both sides
are torch, so :func:`from_torch` / :func:`to_torch` are the identity (a
detached, contiguous tensor on its own device) and what is left is the
facade a torch user needs:

    import torch
    from apex_tpu_torch.interop import TorchFusedOptimizer
    from apex_tpu_torch.optimizers import FusedLAMB

    model = torch.nn.Linear(1024, 1024).cuda()
    opt = TorchFusedOptimizer(model.parameters(), FusedLAMB(impl="fused"))
    loss = model(x).pow(2).mean()
    loss.backward()
    opt.step()            # grads -> the fused flat step -> the parameters
    opt.zero_grad()

``step(grads=None, scale=1.0, lr=None)`` mirrors the reference's
deprecated-contrib ``step(grads=, scale=)`` (``apex/contrib/optimizers/
fused_adam.py:175``).  The optimizer's state lives in the port, keyed to
the parameter list's order; the parameters are re-read from the torch side
every step (torch owns them: ``load_state_dict``, clipping or an EMA swap
may have changed them), and each step takes one of three paths, recorded
in ``last_path``:

- ``"device"``: a fused-impl optimizer with every parameter and gradient
  on the card.  The optimizer's ``TreeFlattener`` packs the gradients and
  the parameters on the device, ``step_flat`` runs (FusedLAMB's launches
  the l2norm kernel once a step) and the new master goes back into each
  ``p.data``;
- ``"host_pack"``: a fused-impl optimizer with CPU, fp32, contiguous
  tensors on both sides.  The threaded host packing
  (:mod:`apex_tpu_torch.utils.host_pack`) fills two reused staging
  buffers, ``step_flat`` runs on them, and the master is unpacked into the
  parameters' storage: the JAX package's fast path;
- ``"per_leaf"``: anything else (the xla impl, other dtypes, strided or
  mixed-device tensors): the optimizer's per-leaf ``step``, with the JAX
  package's one-time warning.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ..utils.pytree import tree_map

__all__ = ["from_torch", "to_torch", "TorchFusedOptimizer"]


def from_torch(t: torch.Tensor) -> torch.Tensor:
    """A torch tensor as the port takes it: detached and contiguous, on its
    own device (the JAX package's DLPack import)."""
    return t.detach().contiguous()


def to_torch(x: torch.Tensor) -> torch.Tensor:
    """The port's tensor as a torch tensor: the same, detached and
    contiguous (the JAX package's DLPack export)."""
    return x.detach().contiguous()


def _clone(tree):
    return tree_map(lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


class TorchFusedOptimizer:
    """Drive a port fused optimizer from a torch loop.

    ``params``: an iterable of torch Parameters / Tensors (any shapes).
    ``optimizer``: any of the port's fused optimizers (FusedAdam, FusedLAMB,
    FusedSGD, ...), either impl."""

    def __init__(self, params: Iterable, optimizer):
        self._params = [p for p in params]
        if not self._params:
            raise ValueError("empty parameter list")
        self.optimizer = optimizer
        # a LIST tree: the flatten order is the parameters' order
        self._state = optimizer.init([from_torch(p.data)
                                      for p in self._params])
        # the host_pack path's staging buffers, made at its first step and
        # reused: a fresh zeroed buffer a step costs page faults on the
        # order of the copies; their gaps stay the zeros the flat math
        # reduces over
        self._stage_g: Optional[np.ndarray] = None
        self._stage_p: Optional[np.ndarray] = None
        #: the path the last step took: "device", "host_pack", "per_leaf"
        self.last_path: Optional[str] = None

    # -- the reference's API --------------------------------------------------

    def zero_grad(self):
        for p in self._params:
            if p.grad is not None:
                p.grad.detach_()
                p.grad.zero_()

    def step(self, grads: Optional[Iterable] = None, scale: float = 1.0,
             lr=None):
        """One fused step.  ``grads`` defaults to each parameter's
        ``.grad``; ``scale`` divides the gradients (amp's loss scale)."""
        if grads is None:
            gs = []
            for p in self._params:
                if p.grad is None:
                    raise RuntimeError("param has no .grad; run backward() "
                                       "or pass grads= explicitly")
                gs.append(p.grad)
        else:
            gs = list(grads)
        self.last_path = self._path(gs)
        if self.last_path == "device":
            return self._step_device(gs, scale, lr)
        if self.last_path == "host_pack":
            return self._step_packed(gs, scale, lr)
        from ..utils.logging import warn_once
        warn_once(
            "interop_slow_path",
            "apex_tpu_torch.interop: using the per-leaf path, which "
            "re-reads every parameter and runs the optimizer leaf by leaf. "
            "The flat paths need a fused-impl optimizer and either every "
            "tensor on the card, or contiguous fp32 CPU tensors on both "
            "sides.")
        ptree = [from_torch(p.data) for p in self._params]
        if getattr(self._state, "master", None) is not None:
            self._state = self._state._replace(
                master=self.optimizer.flattener.flatten(ptree))
        new_params, self._state = self.optimizer.step(
            self._state, [from_torch(g) for g in gs], ptree, scale=scale,
            lr=lr)
        with torch.no_grad():
            for p, new in zip(self._params, new_params):
                p.data.copy_(new)
        return None

    def _path(self, gs) -> str:
        if getattr(self._state, "master", None) is None:
            return "per_leaf"
        tensors = list(self._params) + list(gs)
        if all(t.is_cuda for t in tensors) \
                and len({t.device for t in tensors}) == 1:
            return "device"
        if all(t.device.type == "cpu" and t.dtype == torch.float32
               and t.is_contiguous() for t in tensors):
            return "host_pack"
        return "per_leaf"

    def _step_device(self, gs, scale, lr):
        """Pack on the card, ``step_flat``, the master back into the
        parameters."""
        fl = self.optimizer.flattener
        with torch.no_grad():
            flat_g = fl.flatten([g.detach() for g in gs])
            master = fl.flatten([p.detach() for p in self._params])
            self._state = self.optimizer.step_flat(
                self._state._replace(master=master), flat_g, scale=scale,
                lr=lr)
            for p, new in zip(self._params,
                              fl.unflatten(self._state.master)):
                p.data.copy_(new)
        return None

    def _step_packed(self, gs, scale, lr):
        """One threaded host pack a side, ``step_flat`` on the staging
        buffers, one host unpack into the parameters' storage."""
        from ..utils import host_pack
        fl = self.optimizer.flattener
        if self._stage_g is None:
            self._stage_g = np.zeros((fl.total,), np.float32)
            self._stage_p = np.zeros((fl.total,), np.float32)
        host_pack.pack_like_flattener([g.detach().numpy() for g in gs], fl,
                                      out=self._stage_g)
        host_pack.pack_like_flattener([p.detach().numpy()
                                       for p in self._params], fl,
                                      out=self._stage_p)
        self._state = self.optimizer.step_flat(
            self._state._replace(master=torch.from_numpy(self._stage_p)),
            torch.from_numpy(self._stage_g), scale=scale, lr=lr)
        with torch.no_grad():
            host_pack.unpack(self._state.master.numpy(),
                             [p.data.numpy() for p in self._params],
                             [int(o) for o in fl.offsets[:-1]])
        return None

    # -- checkpointing --------------------------------------------------------

    def state_dict(self):
        """{"state": the optimizer state, "params": the parameters}, both
        copies (the flat master may share the staging buffer)."""
        return {"state": _clone(self._state),
                "params": [p.detach().clone() for p in self._params]}

    def load_state_dict(self, d):
        """The state of :meth:`state_dict`, and its parameters copied into
        the torch side's (a dict keyed ``p0``, ``p1``, ... is read in
        index order, as the JAX package reads its older checkpoints)."""
        dev = self._params[0].device
        self._state = tree_map(lambda t: t.detach().clone().to(dev)
                               if isinstance(t, torch.Tensor) else t,
                               d["state"])
        saved = d["params"]
        if isinstance(saved, dict):
            saved = [saved[k] for k in sorted(saved,
                                              key=lambda k: int(k[1:]))]
        with torch.no_grad():
            for p, cur in zip(self._params, saved):
                p.data.copy_(torch.as_tensor(cur))
