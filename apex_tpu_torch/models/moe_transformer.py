"""Mixture-of-Experts transformer — the model that drives expert
parallelism (:mod:`apex_tpu_torch.parallel.expert`).

Counterpart of ``apex_tpu/models/moe_transformer.py``: a switch-style
encoder, pre-LN attention plus a pre-LN MoE FFN with top-1 routing and a
load-balancing aux loss.  Parameters keep the JAX package's tree — layers
are a Python list of dicts (``qkv`` (D, 3D), ``out`` (D, D), the layer-norm
gains and biases, ``router`` (D, E) and the expert stacks ``w_in`` (E, D,
F) / ``w_out`` (E, F, D), E the local expert count under expert
sharding) — so :func:`moe_params_from_jax` is a plain conversion.

``attn_impl="fast"`` runs the flash kernels, ``"default"`` the plain
softmax core; every layer norm runs through the layer-norm kernels and the
loss through the cross-entropy kernel; ``remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``), the exchanges included.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.utils.checkpoint

from ..contrib.multihead_attn.functional import attention_core
from ..normalization.fused_layer_norm import fused_layer_norm_affine
from ..parallel.expert import MoELayer, moe_ffn
from ..utils.device import from_numpy, resolve_device

__all__ = ["MoETransformerConfig", "moe_transformer_init",
           "moe_transformer_apply", "moe_transformer_loss",
           "moe_params_from_jax"]


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig:
    vocab_size: int = 8192
    max_len: int = 128
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 512
    num_experts: int = 8
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    causal: bool = False        # BERT-style bidirectional
    dtype: Any = torch.float32
    remat: bool = False         # recompute each layer in the backward
    attn_impl: str = "default"  # "fast": the flash kernels
    xent_impl: str = "auto"     # loss: "auto"/"pallas" kernel, "xla" plain

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"num_heads {self.num_heads}")
        return self.d_model // self.num_heads


def moe_transformer_init(cfg: MoETransformerConfig,
                         generator: torch.Generator, n_expert_shards: int = 1,
                         device=None):
    """Random parameters drawn on the CPU from ``generator`` (matrices
    normal * 0.02, layer-norm gains 1 and biases 0, the experts from
    :meth:`MoELayer.init`), moved to ``device`` (default ``"cuda"``);
    expert stacks hold ``num_experts / n_expert_shards`` experts."""
    dev = resolve_device(device)
    D, Fd = cfg.d_model, cfg.d_ff
    moe = MoELayer(d_model=D, d_ff=Fd, num_experts=cfg.num_experts,
                   n_shards=n_expert_shards,
                   capacity_factor=cfg.capacity_factor)

    def dense(*shape):
        return (0.02 * torch.randn(*shape, generator=generator)).to(dev)

    params = {
        "embed": {"tok": dense(cfg.vocab_size, D),
                  "pos": dense(cfg.max_len, D)},
        "layers": [],
        "head_ln_g": torch.ones(D, device=dev),
        "head_ln_b": torch.zeros(D, device=dev),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1_g": torch.ones(D, device=dev),
            "ln1_b": torch.zeros(D, device=dev),
            "qkv": dense(D, 3 * D),
            "out": dense(D, D),
            "ln2_g": torch.ones(D, device=dev),
            "ln2_b": torch.zeros(D, device=dev),
            **moe.init(generator, device=dev),
        })
    return params


def moe_params_from_jax(tree, device=None):
    """The JAX package's MoE parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's, same structure and layout."""
    return from_numpy(tree, device)


def _ln(x, g, b, cfg):
    return fused_layer_norm_affine(x, g.to(cfg.dtype), b.to(cfg.dtype),
                                   (cfg.d_model,))


def _moe_layer(x, lyr, cfg: MoETransformerConfig, expert_axis):
    """One pre-LN attention + MoE-FFN block -> (x, aux)."""
    B, S, _ = x.shape
    dt = cfg.dtype
    H, hd = cfg.num_heads, cfg.head_dim
    h = _ln(x, lyr["ln1_g"], lyr["ln1_b"], cfg)
    qkv = (h.reshape(B * S, -1) @ lyr["qkv"].to(dt)).reshape(
        B, S, 3, cfg.d_model)
    scale = hd ** -0.5
    q = qkv[:, :, 0].reshape(B, S, H, hd).transpose(1, 2) * scale
    k = qkv[:, :, 1].reshape(B, S, H, hd).transpose(1, 2)
    v = qkv[:, :, 2].reshape(B, S, H, hd).transpose(1, 2)
    if cfg.attn_impl == "fast":
        from ..contrib.multihead_attn.flash import flash_attention
        ctx = flash_attention(
            q.reshape(B * H, S, hd).contiguous(),
            k.reshape(B * H, S, hd).contiguous(),
            v.reshape(B * H, S, hd).contiguous(),
            torch.zeros((1, 1, S), dtype=torch.float32, device=x.device),
            causal=cfg.causal, heads=H).reshape(B, H, S, hd)
    else:
        ctx = attention_core(
            q, k, v, torch.zeros((1, S, S), dtype=torch.float32,
                                 device=x.device), causal=cfg.causal)
    ctx = ctx.transpose(1, 2).reshape(B * S, cfg.d_model)
    x = x + (ctx.to(dt) @ lyr["out"].to(dt)).reshape(x.shape)

    h = _ln(x, lyr["ln2_g"], lyr["ln2_b"], cfg)
    moe_out, aux = moe_ffn(h.reshape(B * S, cfg.d_model), lyr["router"],
                           lyr["w_in"], lyr["w_out"], axis_name=expert_axis,
                           capacity_factor=cfg.capacity_factor)
    return x + moe_out.reshape(x.shape).to(dt), aux


def moe_transformer_apply(params, tokens, cfg: MoETransformerConfig, *,
                          expert_axis=None):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux_loss scalar).
    ``expert_axis``: the expert group (a mesh axis name or a process
    group) with expert stacks sharded on their leading dim; None runs
    single-device MoE."""
    if cfg.attn_impl not in ("default", "fast"):
        raise ValueError(
            f"attn_impl must be 'default' or 'fast', got {cfg.attn_impl!r}")
    S = tokens.shape[1]
    dt = cfg.dtype
    emb = params["embed"]
    x = emb["tok"].to(dt)[tokens] + emb["pos"].to(dt)[None, :S, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lyr in params["layers"]:
        fn = functools.partial(_moe_layer, lyr=lyr, cfg=cfg,
                               expert_axis=expert_axis)
        if cfg.remat and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(fn, x,
                                                       use_reentrant=False)
        else:
            x, aux = fn(x)
        aux_total = aux_total + aux
    x = _ln(x, params["head_ln_g"], params["head_ln_b"], cfg)
    logits = torch.einsum("bsd,vd->bsv", x.float(), emb["tok"].float())
    return logits, aux_total


def moe_transformer_loss(params, batch, cfg: MoETransformerConfig, *,
                         expert_axis=None):
    """Masked-LM cross-entropy + ``aux_weight`` * the load-balancing loss.
    batch: ``tokens`` (B, S), ``targets`` (B, S), optional ``weights``."""
    from ..contrib.xentropy import softmax_xentropy_loss
    logits, aux = moe_transformer_apply(params, batch["tokens"], cfg,
                                        expert_axis=expert_axis)
    B, S, V = logits.shape
    nll = softmax_xentropy_loss(logits.reshape(B * S, V),
                                batch["targets"].reshape(B * S), 0.0, -1,
                                False, cfg.xent_impl).reshape(B, S)
    w = batch.get("weights")
    if w is None:
        mlm = nll.mean()
    else:
        mlm = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    return mlm + cfg.aux_weight * aux
