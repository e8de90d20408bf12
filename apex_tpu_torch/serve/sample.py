"""Greedy and temperature/top-k token sampling with per-request keys.

Counterpart of ``apex_tpu/serve/sample.py``.  Every request carries an
integer ``seed``; the token generated at position ``pos`` is drawn from a
``torch.Generator`` seeded with :func:`request_key` ``(seed, pos)`` — a pure
function of request state, independent of the continuous-batching slot the
request occupies or who shares the batch.  That is the deterministic-replay
contract: replaying a request alone reproduces its sampled tokens.  The
draws are not JAX's threefry bits; only the contract carries over.

``temperature <= 0`` is greedy (argmax, ties to the first index);
``top_k <= 0`` disables the top-k filter, which keeps every logit >= the
k-th largest (ties keep more than k candidates).  Sampling is Gumbel-max
over the filtered, temperature-scaled logits.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["request_key", "sample_token", "sample_batch"]

_M64 = (1 << 64) - 1


def request_key(seed: int, pos: int) -> int:
    """The generator seed for the token generated at ``pos`` of the request
    seeded ``seed``: a splitmix64 finaliser over (seed, pos)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)) & _M64
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return z & ((1 << 63) - 1)


def sample_token(logits: torch.Tensor, key: int, temperature: float,
                 top_k: int) -> torch.Tensor:
    """One token id (0-d int64 tensor on ``logits``' device) from
    ``logits`` (V,).  ``temperature`` and ``top_k`` are host numbers."""
    lg = logits.float()
    if temperature <= 0.0:
        return lg.argmax()
    if top_k > 0:
        thresh = torch.topk(lg, min(int(top_k), lg.shape[-1])).values[-1]
        lg = lg.masked_fill(lg < thresh, float("-inf"))
    gen = torch.Generator(device=lg.device)
    gen.manual_seed(key)
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    gumbel = -torch.log(-torch.log(u))
    return (lg / max(float(temperature), 1e-6) + gumbel).argmax()


def sample_batch(logits: torch.Tensor, seeds: Sequence[int],
                 positions: Sequence[int], temperatures: Sequence[float],
                 top_ks: Sequence[int]) -> torch.Tensor:
    """Per-slot sampling over a decode batch: ``logits`` (W, V) with
    per-slot host seeds / generated-token positions / temperatures /
    top-k values.  Returns (W,) int64 on ``logits``' device; each slot's
    token depends only on its own row and request state."""
    toks = logits.float().argmax(dim=-1)
    for w in range(logits.shape[0]):
        if float(temperatures[w]) > 0.0:
            toks[w] = sample_token(logits[w], request_key(seeds[w],
                                                          positions[w]),
                                   float(temperatures[w]), int(top_ks[w]))
    return toks
