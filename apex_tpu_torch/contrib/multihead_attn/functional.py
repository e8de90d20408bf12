"""Plain attention functions: the ``impl="default"`` path.

Counterpart of ``apex_tpu/contrib/multihead_attn/functional.py`` (the
reference's ``self_multihead_attn_func.py`` / ``encdec_multihead_attn_func.py``),
with the same mask semantics:

  - ``key_padding_mask`` (B, Sk) bool/int: nonzero = PAD (masked out);
  - ``attn_mask`` (Sq, Sk) bool: True = masked (time mask);
  - ``mask_additive``: the mask is float and *added* to the scores;
  - softmax, then dropout on the probabilities.

The projections are ``torch.matmul``, as the JAX package's are plain XLA
products.  Dropout draws its keep mask from a ``torch.Generator``
(:func:`bernoulli_keep`), where the JAX package draws
``jax.random.bernoulli``: the keep rate is the same, the bits are not.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["build_bias", "attention_core", "bernoulli_keep", "draw_seed",
           "self_attn_func", "encdec_attn_func", "_split_heads",
           "_merge_heads"]

Rng = Union[torch.Generator, int, None]


def build_bias(mask, mask_additive, *, batch, sq, sk, use_time_mask,
               device=None) -> torch.Tensor:
    """Normalize every reference mask flavour into an additive f32 bias of
    shape (1|B, 1|Sq, Sk) (-inf where masked).  ``device`` places the
    zero bias of ``mask=None`` (default the CPU)."""
    if mask is None:
        return torch.zeros((1, 1, sk), dtype=torch.float32, device=device)
    if mask_additive:
        m = mask.to(torch.float32)
        if m.dim() == 1:
            m = m[None, :]
        return m.reshape(m.shape[0], 1, sk)
    neg = torch.full((), float("-inf"), dtype=torch.float32,
                     device=mask.device)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    if use_time_mask:           # (Sq, Sk) bool, True = masked
        return torch.where(mask.bool(), neg, zero)[None]
    # key padding (B, Sk), nonzero = pad
    return torch.where(mask.bool(), neg, zero).reshape(batch, 1, sk)


def draw_seed(gen: torch.Generator) -> int:
    """One int32 seed drawn from ``gen`` (on its own device)."""
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=gen,
                             device=gen.device))


def bernoulli_keep(shape, keep_prob: float, rng: Rng,
                   device) -> torch.Tensor:
    """A float32 keep mask (1 with probability ``keep_prob``) on
    ``device``.  ``rng`` is a ``torch.Generator`` on that device (drawn
    from directly), a generator elsewhere (one int32 seed is drawn from it
    for a generator on ``device``: no host-sized mask crosses to the card)
    or an int (that seed)."""
    device = torch.device(device)
    if isinstance(rng, torch.Generator) and rng.device.type == device.type:
        gen = rng
    else:
        if isinstance(rng, torch.Generator):
            rng = draw_seed(rng)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng) & 0xFFFFFFFFFFFFFFFF)
    u = torch.rand(shape, generator=gen, device=device)
    return (u < keep_prob).to(torch.float32)


def attention_core(q, k, v, bias, *, causal=False, dropout_rate=0.0,
                   dropout_rng: Rng = None, heads=1) -> torch.Tensor:
    """q (B, H, Sq, D) pre-scaled, k/v (B, H, Sk, D), bias (1|B, 1|Sq, Sk).
    Returns (B, H, Sq, D): the reference math path (softmax -> dropout ->
    PV), scores in fp32.  A row whose keys are all masked gives NaN, as in
    the JAX package."""
    del heads
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s + bias[:, None, :, :]
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where((cols <= rows)[None, None], s,
                        torch.full((), float("-inf"), device=q.device))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = bernoulli_keep(p.shape, 1.0 - dropout_rate, dropout_rng,
                              p.device)
        p = p * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _split_heads(x, heads):
    """(S, B, E) -> (B, H, S, D), a permuted view (the reference's
    seqs*heads batching)."""
    S, B, E = x.shape
    return x.reshape(S, B, heads, E // heads).permute(1, 2, 0, 3)


def _merge_heads(x):
    """(B, H, S, D) -> (S, B, E)."""
    B, H, S, D = x.shape
    return x.permute(2, 0, 1, 3).reshape(S, B, H * D)


def self_attn_func(use_time_mask, is_training, heads, scale, inputs,
                   input_weights, output_weights, input_biases,
                   output_biases, mask, mask_additive, dropout_prob,
                   dropout_rng: Rng = None):
    """Signature mirror of ``SelfAttnFunc.forward``.  inputs (Sq, B, E);
    weights in the reference's layout: input_weights (3E, E),
    output_weights (E, E)."""
    S, B, E = inputs.shape
    x = inputs.reshape(S * B, E)
    lin = torch.matmul(x, input_weights.t().to(x.dtype))
    if input_biases is not None:
        lin = lin + input_biases.to(lin.dtype)
    lin = lin.reshape(S, B, 3, E)
    q, k, v = (_split_heads(lin[:, :, i, :], heads) for i in range(3))

    bias = build_bias(mask, mask_additive, batch=B, sq=S, sk=S,
                      use_time_mask=use_time_mask, device=inputs.device)
    drop = dropout_prob if is_training else 0.0
    ctx = attention_core(q * scale, k, v, bias, dropout_rate=drop,
                         dropout_rng=dropout_rng, heads=heads)
    ctx = _merge_heads(ctx)                                   # (S, B, E)
    out = torch.matmul(ctx.reshape(S * B, E),
                       output_weights.t().to(ctx.dtype))
    if output_biases is not None:
        out = out + output_biases.to(out.dtype)
    return out.reshape(S, B, E)


def encdec_attn_func(use_time_mask, is_training, heads, scale, inputs_q,
                     inputs_kv, input_weights_q, input_weights_kv,
                     output_weights, mask, dropout_prob,
                     dropout_rng: Rng = None):
    """Mirror of ``EncdecAttnFunc.forward``: a Q projection (E, E) of the
    decoder stream and a fused KV projection (2E, E) of the encoder's."""
    Sq, B, E = inputs_q.shape
    Sk = inputs_kv.shape[0]
    q = torch.matmul(inputs_q.reshape(Sq * B, E),
                     input_weights_q.t().to(inputs_q.dtype)).reshape(Sq, B, E)
    kv = torch.matmul(inputs_kv.reshape(Sk * B, E),
                      input_weights_kv.t().to(inputs_kv.dtype)
                      ).reshape(Sk, B, 2, E)
    qh = _split_heads(q, heads)
    kh = _split_heads(kv[:, :, 0, :], heads)
    vh = _split_heads(kv[:, :, 1, :], heads)

    bias = build_bias(mask, False, batch=B, sq=Sq, sk=Sk,
                      use_time_mask=use_time_mask, device=inputs_q.device)
    drop = dropout_prob if is_training else 0.0
    ctx = attention_core(qh * scale, kh, vh, bias, dropout_rate=drop,
                         dropout_rng=dropout_rng, heads=heads)
    ctx = _merge_heads(ctx)
    out = torch.matmul(ctx.reshape(Sq * B, E),
                       output_weights.t().to(ctx.dtype))
    return out.reshape(Sq, B, E)
