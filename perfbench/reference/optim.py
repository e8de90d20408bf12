"""LAMB and Adam(W) written from their published updates, per tensor, in
float32, with the settings the configurations state.  Each keeps its
state in a dict and updates the parameter list in place."""
from __future__ import annotations

from typing import List

import torch


class Lamb:
    """LAMB (You et al. 2019) as NVIDIA's FusedLAMB states it: the
    gradients clipped by their global norm to ``max_grad_norm``, Adam
    moments with bias correction, decoupled weight decay on every tensor,
    and each tensor's step scaled by ||p|| / ||update|| (1 where either is
    zero)."""

    def __init__(self, lr, weight_decay, max_grad_norm, betas=(0.9, 0.999),
                 eps=1e-6):
        self.lr, self.wd, self.max_norm = lr, weight_decay, max_grad_norm
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m: List[torch.Tensor] = []
        self.v: List[torch.Tensor] = []

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        if not self.m:
            self.m = [torch.zeros_like(p) for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        self.t += 1
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        clip = 1.0 / torch.clamp(gnorm / self.max_norm, min=1.0)
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = g * clip
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            wn, un = p.norm(), u.norm()
            ratio = torch.where((wn > 0) & (un > 0), wn / un,
                                torch.ones_like(wn))
            p.sub_(self.lr * ratio * u)


class Adam:
    """Adam with bias correction and decoupled decay (AdamW's form), the
    settings of NVIDIA's FusedAdam by default."""

    def __init__(self, lr, weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m: List[torch.Tensor] = []
        self.v: List[torch.Tensor] = []

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        if not self.m:
            self.m = [torch.zeros_like(p) for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            p.sub_(self.lr * u)
