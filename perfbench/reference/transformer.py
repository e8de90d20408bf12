"""BERT-style encoder, masked-LM loss and its gradients in plain float32
PyTorch: the model of ``configs/bert_large.json`` as the program computes
it (pre-LN blocks with an embedding layer norm, tanh GELU, a tied head
with no transform layer, attention dropout on the probabilities by the
counter hash of :mod:`.hash`).

Parameters are a dict tree of float32 tensors: ``embed`` {tok (V, D), pos
(P, D), ln_g, ln_b}, ``layers`` {wqkv (L, D, 3D), bqkv, wo (L, D, D), bo,
ln1_g, ln1_b, w1 (L, D, F), b1, w2 (L, F, D), b2, ln2_g, ln2_b} and
``head`` {ln_g, ln_b}; the projections are input-major, ``x @ w``."""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from .hash import dropout_keep
from .tree import leaves

EPS = 1e-5


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, EPS)


def identity(x):
    return x


def _attention(h, lp, heads: int, seed: int, rate: float, row0: int,
               mm: Callable, act: Callable):
    b, s, d = h.shape
    hd = d // heads
    qkv = act(mm(h, lp["wqkv"]) + lp["bqkv"])
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    probs = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd), -1)
    if rate > 0.0:
        bh = torch.arange(row0 * heads, (row0 + b) * heads,
                          device=h.device)[:, None, None]
        keep = dropout_keep(seed, bh, s, s, rate).view(b, heads, s, s)
        probs = probs * keep / (1.0 - rate)
    ctx = act(mm(act(probs), v)).transpose(1, 2).reshape(b, s, d)
    return act(mm(ctx, lp["wo"]) + lp["bo"])


def loss_sum(params, tokens, targets, weights, heads: int,
             seeds: List[int], rate: float, row0: int,
             mm: Callable = torch.matmul,
             act: Callable = identity) -> torch.Tensor:
    """Sum of the weighted token losses of the rows ``tokens`` (b, S),
    which start at row ``row0`` of the step's batch (the dropout mask's
    head index counts from it).  ``mm`` computes every product and ``act``
    rounds every activation the model keeps between operations (the
    identity here; the control's lower precision)."""
    emb, lay = params["embed"], params["layers"]
    s = tokens.shape[1]
    x = act(_ln(emb["tok"][tokens] + emb["pos"][:s][None], emb["ln_g"],
                emb["ln_b"]))
    for i, seed in enumerate(seeds):
        lp = {k: v[i] for k, v in lay.items()}
        x = act(x + _attention(act(_ln(x, lp["ln1_g"], lp["ln1_b"])), lp,
                               heads, seed, rate, row0, mm, act))
        h = act(F.gelu(act(mm(act(_ln(x, lp["ln2_g"], lp["ln2_b"])),
                              lp["w1"]) + lp["b1"]), approximate="tanh"))
        x = act(x + act(mm(h, lp["w2"]) + lp["b2"]))
    # weights are zero off the predicted positions: the head runs on those
    pick = weights > 0
    xs = act(_ln(x[pick], params["head"]["ln_g"], params["head"]["ln_b"]))
    logits = act(mm(xs, emb["tok"].t()))
    nll = torch.logsumexp(logits, -1) \
        - logits.gather(1, targets[pick][:, None])[:, 0]
    return (nll * weights[pick]).sum()


def loss_and_grads(params, batch: Dict[str, torch.Tensor], heads: int,
                   seeds: List[int], rate: float, chunk: int,
                   mm: Callable = torch.matmul, act: Callable = identity):
    """(loss, grads in :func:`leaves` order) of one step over the whole
    batch, ``chunk`` rows at a time: the loss is the weighted mean over
    every predicted position of the batch, as the program's."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    w = batch["weights"].float()
    denom = torch.clamp(w.sum(), min=1.0)
    total = torch.zeros((), device=w.device)
    grads = [torch.zeros_like(p) for p in ps]
    for r in range(0, w.shape[0], chunk):
        part = loss_sum(params, batch["tokens"][r:r + chunk],
                        batch["targets"][r:r + chunk], w[r:r + chunk], heads,
                        seeds, rate, r, mm, act) / denom
        for g, d in zip(grads, torch.autograd.grad(part, ps)):
            g.add_(d)
        total += part.detach()
        del part
    for p in ps:
        p.requires_grad_(False)
    return total, grads
