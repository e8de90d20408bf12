"""BERT-style transformer encoder LM, forward only.

Counterpart of ``apex_tpu/models/transformer.py``.  Parameters are a nested
dict of tensors with the JAX package's structure and layout: per-layer
weights are stacked on a leading ``num_layers`` axis and projections keep
the ``(D, 3D)`` / ``(D, F)`` input-major layout, so :func:`params_from_jax`
is a plain conversion and no weight is transposed anywhere.

``attn_impl="fast"`` routes the attention core through the flash kernel
(:mod:`apex_tpu_torch.contrib.multihead_attn.flash`); ``"default"`` is the
plain softmax path, the numerics oracle.  Every layer norm goes through the
layer-norm kernel (:mod:`apex_tpu_torch.normalization`).  Training-only
options of the JAX config (dropout masks from an rng, remat, the loss
kernel, scan unrolling) come with the training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..normalization.fused_layer_norm import fused_layer_norm_affine
from ..utils.device import resolve_device

__all__ = ["TransformerConfig", "bert_large_config", "transformer_init",
           "transformer_apply", "params_from_jax"]

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    max_len: int = 512
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    dropout: float = 0.0          # inference: no dropout is applied
    causal: bool = False          # BERT-style bidirectional by default
    dtype: Any = torch.float32    # activation dtype
    tie_embeddings: bool = True
    attn_impl: str = "default"    # "default": plain softmax; "fast": flash

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"num_heads {self.num_heads}")
        return self.d_model // self.num_heads


def bert_large_config(**overrides) -> TransformerConfig:
    base = dict(vocab_size=30592, max_len=512, num_layers=24, d_model=1024,
                num_heads=16, d_ff=4096)
    base.update(overrides)
    return TransformerConfig(**base)


def transformer_init(cfg: TransformerConfig, generator: torch.Generator,
                     device=None) -> Params:
    """Random parameters (normal * 0.02 for matrices, LN gains 1, biases
    0), drawn on the CPU from ``generator`` so a seed gives the same weights
    on every device, then moved to ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    L, D, Fd, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size

    def dense(*shape):
        return (0.02 * torch.randn(*shape, generator=generator)).to(dev)

    def ones(*shape):
        return torch.ones(*shape, device=dev)

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    params = {
        "embed": {"tok": dense(V, D), "pos": dense(cfg.max_len, D),
                  "ln_g": ones(D), "ln_b": zeros(D)},
        "layers": {
            "wqkv": dense(L, D, 3 * D), "bqkv": zeros(L, 3 * D),
            "wo": dense(L, D, D), "bo": zeros(L, D),
            "ln1_g": ones(L, D), "ln1_b": zeros(L, D),
            "w1": dense(L, D, Fd), "b1": zeros(L, Fd),
            "w2": dense(L, Fd, D), "b2": zeros(L, D),
            "ln2_g": ones(L, D), "ln2_b": zeros(L, D),
        },
        "head": {"ln_g": ones(D), "ln_b": zeros(D)},
    }
    if not cfg.tie_embeddings:
        params["head"]["out"] = dense(D, V)
    return params


def params_from_jax(tree, device=None) -> Params:
    """The JAX package's parameter pytree (as numpy arrays, or anything
    ``np.asarray`` takes) -> the port's parameters, same structure, same
    layout, same values."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights from the stacked ``(L, ...)`` leaves."""
    return {k: v[i] for k, v in params["layers"].items()}


def ln(x, g, b, cfg: TransformerConfig):
    return fused_layer_norm_affine(x, g.to(x.dtype), b.to(x.dtype),
                                   (cfg.d_model,))


def embed(params: Params, tokens, pos_rows, cfg: TransformerConfig):
    emb = params["embed"]
    x = emb["tok"][tokens].to(cfg.dtype) + pos_rows.to(cfg.dtype)
    return ln(x, emb["ln_g"], emb["ln_b"], cfg)


def mlp(x, lp, cfg: TransformerConfig):
    """``x + ff2(gelu(ff1(ln2(x))))``; tanh gelu, as ``jax.nn.gelu``."""
    dt = x.dtype
    h = ln(x, lp["ln2_g"], lp["ln2_b"], cfg)
    h = h @ lp["w1"].to(dt) + lp["b1"].to(dt)
    h = F.gelu(h, approximate="tanh")
    h = h @ lp["w2"].to(dt) + lp["b2"].to(dt)
    return x + h


def head(params: Params, x, cfg: TransformerConfig):
    dt = x.dtype
    x = ln(x, params["head"]["ln_g"], params["head"]["ln_b"], cfg)
    w_out = (params["embed"]["tok"].t() if cfg.tie_embeddings
             else params["head"]["out"]).to(dt)
    return x @ w_out


def qkv_heads(h, lp, cfg: TransformerConfig):
    """-> q, k, v each (B, S, H, hd)."""
    B, S, _ = h.shape
    dt = h.dtype
    qkv = h @ lp["wqkv"].to(dt) + lp["bqkv"].to(dt)
    q, k, v = qkv.split(cfg.d_model, dim=-1)
    shape = (B, S, cfg.num_heads, cfg.head_dim)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def attention_core(q, k, v, cfg: TransformerConfig, mask=None):
    """q, k, v (B, H, S, hd) -> ctx (B, H, S, hd).  ``mask``: optional
    key-padding mask (B, S), nonzero = PAD."""
    B, H, S, hd = q.shape
    dt = q.dtype
    if cfg.attn_impl == "fast":
        from ..contrib.multihead_attn.flash import flash_attention
        scale = 1.0 / math.sqrt(hd)
        qf = (q.float() * scale).to(dt).reshape(B * H, S, hd).contiguous()
        if mask is not None:
            bias = torch.where(mask[:, None, :] != 0, -1e9, 0.0) \
                .to(torch.float32)
        else:
            bias = torch.zeros((1, 1, S), dtype=torch.float32, device=q.device)
        ctx = flash_attention(qf, k.reshape(B * H, S, hd).contiguous(),
                              v.reshape(B * H, S, hd).contiguous(),
                              bias.contiguous(), seed=0, causal=cfg.causal,
                              dropout_rate=0.0, heads=H)
        return ctx.reshape(B, H, S, hd)
    # JAX divides by sqrt(hd) in the activation dtype
    scores = (q @ k.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(float(hd), dtype=dt, device=q.device))
    if cfg.causal:
        causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :] != 0, -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    return probs @ v


def attention(h, lp, cfg: TransformerConfig, mask=None):
    """Self-attention block output ``(B, S, D)`` plus this layer's k, v in
    (B, S, H, hd) (the layout the serving engine pages)."""
    B, S, D = h.shape
    q, k, v = qkv_heads(h, lp, cfg)
    ctx = attention_core(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), cfg, mask)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    dt = h.dtype
    return ctx @ lp["wo"].to(dt) + lp["bo"].to(dt), k, v


def transformer_apply(params: Params, tokens: torch.Tensor,
                      cfg: TransformerConfig, *,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V).  Pre-LN blocks, tied head.
    ``mask``: optional key-padding mask (B, S), nonzero = PAD."""
    if cfg.attn_impl not in ("default", "fast"):
        raise ValueError(
            f"attn_impl must be 'default' or 'fast', got {cfg.attn_impl!r}")
    S = tokens.shape[1]
    x = embed(params, tokens, params["embed"]["pos"][:S][None], cfg)
    for i in range(params["layers"]["wqkv"].shape[0]):
        lp = layer(params, i)
        h = ln(x, lp["ln1_g"], lp["ln1_b"], cfg)
        out, _, _ = attention(h, lp, cfg, mask)
        x = mlp(x + out, lp, cfg)
    return head(params, x, cfg)
