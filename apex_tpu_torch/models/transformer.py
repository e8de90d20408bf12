"""BERT-style transformer encoder LM.

Counterpart of ``apex_tpu/models/transformer.py``.  Parameters are a nested
dict of tensors with the JAX package's structure and layout: per-layer
weights are stacked on a leading ``num_layers`` axis and projections keep
the ``(D, 3D)`` / ``(D, F)`` input-major layout, so :func:`params_from_jax`
is a plain conversion and no weight is transposed anywhere.

``attn_impl="fast"`` routes the attention core through the flash kernels
(:mod:`apex_tpu_torch.contrib.multihead_attn.flash`); ``"default"`` is the
plain softmax path, the numerics oracle.  Every layer norm goes through the
layer-norm kernels (:mod:`apex_tpu_torch.normalization`), and
:func:`transformer_loss` through the cross-entropy kernel
(:mod:`apex_tpu_torch.contrib.xentropy`).  Gradients come from autograd;
``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``).  Attention dropout takes a
``torch.Generator`` from which each layer draws an int32 seed for the
counter-hash mask, so its bits differ from the JAX package's key splitting.
The JAX config's ``scan_unroll`` has no counterpart: layers run in a Python
loop.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..contrib.multihead_attn.flash import _dropout_keep
from ..normalization.fused_layer_norm import fused_layer_norm_affine
from ..utils.device import from_numpy, resolve_device

__all__ = ["TransformerConfig", "bert_large_config", "transformer_init",
           "transformer_apply", "transformer_loss", "params_from_jax"]

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    max_len: int = 512
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    dropout: float = 0.0          # attention dropout, when an rng is given
    causal: bool = False          # BERT-style bidirectional by default
    dtype: Any = torch.float32    # activation dtype
    tie_embeddings: bool = True
    remat: bool = False           # recompute each layer in the backward
    attn_impl: str = "default"    # "default": plain softmax; "fast": flash
    xent_impl: str = "auto"       # loss: "auto"/"pallas" kernel, "xla" plain

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
    return from_numpy(tree, device)


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


def attention_core(q, k, v, cfg: TransformerConfig, mask=None, seed=0,
                   rate=0.0):
    """q, k, v (B, H, S, hd) -> ctx (B, H, S, hd).  ``mask``: optional
    key-padding mask (B, S), nonzero = PAD.  ``rate`` > 0: attention
    dropout with the counter-hash mask of ``seed``."""
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
                              bias.contiguous(), seed=seed, causal=cfg.causal,
                              dropout_rate=rate, heads=H)
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
    if rate > 0.0:
        bh = torch.arange(B * H, device=q.device)[:, None, None]
        keep = _dropout_keep(seed, bh, 0, 0, (S, S), rate).view(B, H, S, S)
        probs = probs * keep.to(dt) / (1.0 - rate)
    return probs @ v


def attention(h, lp, cfg: TransformerConfig, mask=None, seed=0, rate=0.0,
              attn_override=None):
    """Self-attention block output ``(B, S, D)`` plus this layer's k, v in
    (B, S, H, hd) (the layout the serving engine pages).

    ``attn_override``: a callable ``(q, k, v, *, causal) -> ctx`` over the
    (B, H, S, hd) layout that replaces the attention core, the hook the
    sequence-parallel engine (:mod:`apex_tpu_torch.parallel.spmd`) routes
    ring / Ulysses attention through.  It owns the 1/sqrt(hd) scaling; a
    key-padding mask does not compose with it and raises."""
    B, S, D = h.shape
    q, k, v = qkv_heads(h, lp, cfg)
    if attn_override is not None:
        if mask is not None:
            raise ValueError(
                "attn_override does not compose with a key-padding mask "
                "(the sequence-parallel collectives carry no mask plumbing)")
        ctx = attn_override(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=cfg.causal)
        ctx = ctx.to(h.dtype)
    else:
        ctx = attention_core(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), cfg, mask, seed, rate)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    dt = h.dtype
    return ctx @ lp["wo"].to(dt) + lp["bo"].to(dt), k, v


def block(x, lp, cfg: TransformerConfig, mask=None, seed=0, rate=0.0,
          attn_override=None):
    """One pre-LN layer: ``x + attn(ln1(x))``, then the MLP block."""
    h = ln(x, lp["ln1_g"], lp["ln1_b"], cfg)
    out, _, _ = attention(h, lp, cfg, mask, seed, rate, attn_override)
    return mlp(x + out, lp, cfg)


def _layer_seeds(n_layers: int, dropout_rng: Optional[torch.Generator]
                 ) -> List[int]:
    """One int32 flash seed per layer, drawn up front (a layer recomputed
    under remat must see the same mask)."""
    if dropout_rng is None:
        return [0] * n_layers
    return torch.randint(-2 ** 31, 2 ** 31, (n_layers,),
                         generator=dropout_rng).tolist()


def transformer_apply(params: Params, tokens: torch.Tensor,
                      cfg: TransformerConfig, *,
                      mask: Optional[torch.Tensor] = None,
                      dropout_rng: Optional[torch.Generator] = None,
                      attn_override=None, pos_offset: Optional[int] = None
                      ) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V).  Pre-LN blocks, tied head.
    ``mask``: optional key-padding mask (B, S), nonzero = PAD.
    ``dropout_rng``: a (CPU) ``torch.Generator``; with it, attention
    dropout at ``cfg.dropout``.

    ``attn_override`` / ``pos_offset`` are the sequence-parallel hooks
    (:mod:`apex_tpu_torch.parallel.spmd`): the override replaces every
    layer's attention core (see :func:`attention`), and ``pos_offset``
    (this rank's global position of its first local token) slices the
    position rows at that offset, so a sequence-sharded rank reads its own
    positions, not ``[0, S_local)``."""
    if cfg.attn_impl not in ("default", "fast"):
        raise ValueError(
            f"attn_impl must be 'default' or 'fast', got {cfg.attn_impl!r}")
    S = tokens.shape[1]
    off = 0 if pos_offset is None else int(pos_offset)
    x = embed(params, tokens, params["embed"]["pos"][off:off + S][None], cfg)
    # one unbind per stacked leaf: its backward stacks the layer grads once
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    n_layers = params["layers"]["wqkv"].shape[0]
    rate = cfg.dropout if dropout_rng is not None else 0.0
    for i, seed in enumerate(_layer_seeds(n_layers, dropout_rng)):
        lp = {k: v[i] for k, v in stacked.items()}
        fn = functools.partial(block, lp=lp, cfg=cfg, mask=mask, seed=seed,
                               rate=rate, attn_override=attn_override)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        else:
            x = fn(x)
    return head(params, x, cfg)


def transformer_loss(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: TransformerConfig, *,
                     dropout_rng: Optional[torch.Generator] = None,
                     smoothing: float = 0.0, attn_override=None,
                     pos_offset: Optional[int] = None) -> torch.Tensor:
    """Masked-LM cross-entropy through the fused xentropy kernel.  batch:
    ``tokens`` (B, S) int, ``targets`` (B, S) int, optional ``weights``
    (B, S) float and ``mask`` (B, S).  ``padding_idx=-1``: padding is
    expressed through ``weights``, and vocab id 0 is a legal target.
    ``attn_override`` / ``pos_offset`` thread through to
    :func:`transformer_apply` (sequence parallelism)."""
    from ..contrib.xentropy import softmax_xentropy_loss
    logits = transformer_apply(params, batch["tokens"], cfg,
                               mask=batch.get("mask"),
                               dropout_rng=dropout_rng,
                               attn_override=attn_override,
                               pos_offset=pos_offset)
    B, S, V = logits.shape
    nll = softmax_xentropy_loss(logits.reshape(B * S, V),
                                batch["targets"].reshape(B * S), smoothing,
                                -1, False, cfg.xent_impl).reshape(B, S)
    w = batch.get("weights")
    if w is None:
        return nll.mean()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
