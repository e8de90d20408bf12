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

Tensor parallelism (Megatron's column / row splits, where the JAX package
lets GSPMD place its collectives by :func:`transformer_pspecs`): each
layer function takes ``tp_group`` (default None, the unsplit model).  With
a group, the parameters are this rank's shards (:func:`tp_shard_params`):
the attention's QKV columns of its ``H / tp`` heads and the matching rows
of ``wo``, the MLP's ``w1`` columns and ``w2`` rows, and the vocabulary's
rows of ``embed.tok`` (and columns of an untied ``head.out``).  Each
column product starts with :func:`~apex_tpu_torch.parallel.comm.
copy_to_tp`, each row product ends with :func:`~apex_tpu_torch.parallel.
comm.reduce_from_tp` before its bias, the embedding is a masked local
lookup summed over the group, the head gives this rank's vocabulary
columns of the logits, and :func:`transformer_loss` takes the
vocab-parallel cross-entropy (the row maxima, the sums of exponentials
and the gold logits all-reduced; the whole ``(B, S, V)`` logits never
sit on one rank).  Layer norms, position rows and the biases after a row
product are replicated, and their gradients come out the same on every
rank.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

import torch.distributed as dist

from ..contrib.multihead_attn.flash import _dropout_keep
from ..normalization.fused_layer_norm import fused_layer_norm_affine
from ..parallel import comm
from ..telemetry import trace as _trace
from ..utils import tuning
from ..utils.device import from_numpy, resolve_device

__all__ = ["TransformerConfig", "bert_large_config", "transformer_init",
           "transformer_apply", "transformer_loss", "params_from_jax",
           "transformer_pspecs", "tp_shard_params", "tp_gather_params",
           "REPLICATED"]

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
    """BERT-large's widths; the attention route is ``attn_impl`` when it is
    among the overrides, else the tuning profile's ``bert_attn_impl`` (on
    the card only), else the config's default."""
    base = dict(vocab_size=30592, max_len=512, num_layers=24, d_model=1024,
                num_heads=16, d_ff=4096)
    tuned_attn = tuning.get_on_gpu("bert_attn_impl")
    if tuned_attn and "attn_impl" not in overrides:
        base["attn_impl"] = tuned_attn
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


#: a leaf every rank holds whole (the JAX package's ``P()``)
REPLICATED = "replicated"


def transformer_pspecs(cfg: TransformerConfig, *, dp="data", tp="model"):
    """The Megatron tensor-parallel placement of :func:`transformer_init`'s
    tree, the JAX package's ``PartitionSpec`` tree as strings: a sharded
    leaf is ``"<tp>:<dim>"`` (its dim ``dim`` split over the ``tp`` axis),
    every other leaf :data:`REPLICATED`.  Column splits: ``wqkv`` /
    ``bqkv`` (by head) and ``w1`` / ``b1``; row splits: ``wo`` and ``w2``;
    ``embed.tok`` by vocabulary row, an untied ``head.out`` by vocabulary
    column.  ``dp``: the parameters are replicated over it."""
    del dp
    rep = REPLICATED
    head = {"ln_g": rep, "ln_b": rep}
    if not cfg.tie_embeddings:
        head["out"] = f"{tp}:1"
    return {
        "embed": {"tok": f"{tp}:0", "pos": rep, "ln_g": rep, "ln_b": rep},
        "layers": {
            "wqkv": f"{tp}:2", "bqkv": f"{tp}:1",
            "wo": f"{tp}:1", "bo": rep,
            "ln1_g": rep, "ln1_b": rep,
            "w1": f"{tp}:2", "b1": f"{tp}:1",
            "w2": f"{tp}:1", "b2": rep,
            "ln2_g": rep, "ln2_b": rep,
        },
        "head": head,
    }


def spec_dim(spec: str) -> Optional[int]:
    """The sharded dim of a :func:`transformer_pspecs` leaf, None for a
    replicated one."""
    return None if spec == REPLICATED else int(spec.rsplit(":", 1)[1])


def _check_tp(cfg: TransformerConfig, tp: int) -> None:
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by "
                         f"model-axis size {tp}")
    if cfg.vocab_size % tp or cfg.d_ff % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} and d_ff {cfg.d_ff} "
                         f"must divide over the model axis ({tp})")


def _head_columns(cfg: TransformerConfig, rank: int, tp: int) -> torch.Tensor:
    """The QKV columns of rank ``rank``'s heads, ``[q | k | v]`` of them:
    the fused projection's columns are q, k and v of every head in turn,
    so a contiguous ``3D / tp`` slice would mix q and k."""
    D = cfg.d_model
    w = D // tp
    own = torch.arange(rank * w, (rank + 1) * w)
    return torch.cat([own, own + D, own + 2 * D])


def _walk(specs, trees, fn, path=()):
    if isinstance(specs, dict):
        return {k: _walk(specs[k], [t[k] for t in trees], fn, path + (k,))
                for k in specs}
    return fn(path, specs, trees)


def tp_shard_params(params: Params, cfg: TransformerConfig, rank: int,
                    tp: int) -> Params:
    """Rank ``rank``'s Megatron shards of the whole model ``params`` (the
    tree :func:`transformer_init` / :func:`params_from_jax` give) over a
    model axis of ``tp``: every sharded leaf of :func:`transformer_pspecs`
    sliced on its dim, ``wqkv`` / ``bqkv`` by head; replicated leaves as
    they are.  At ``tp == 1`` every leaf keeps its values and layout."""
    _check_tp(cfg, tp)
    cols = _head_columns(cfg, rank, tp)

    def shard(path, spec, leaves):
        leaf = leaves[0]
        dim = spec_dim(spec)
        if dim is None:
            return leaf
        if path[-1] in ("wqkv", "bqkv"):
            return leaf.index_select(dim, cols.to(leaf.device))
        n = leaf.shape[dim] // tp
        return leaf.narrow(dim, rank * n, n).contiguous()

    return _walk(transformer_pspecs(cfg), [params], shard)


def tp_gather_params(shards, cfg: TransformerConfig) -> Params:
    """The inverse of :func:`tp_shard_params`: the whole model from the
    list of every rank's shards, in rank order."""
    tp = len(shards)
    _check_tp(cfg, tp)
    order = torch.argsort(torch.cat([_head_columns(cfg, r, tp)
                                     for r in range(tp)]))

    def gather(path, spec, leaves):
        dim = spec_dim(spec)
        if dim is None:
            return leaves[0]
        whole = torch.cat(list(leaves), dim)
        if path[-1] in ("wqkv", "bqkv"):
            whole = whole.index_select(dim, order.to(whole.device))
        return whole

    return _walk(transformer_pspecs(cfg), shards, gather)


def layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights from the stacked ``(L, ...)`` leaves."""
    return {k: v[i] for k, v in params["layers"].items()}


def ln(x, g, b, cfg: TransformerConfig):
    return fused_layer_norm_affine(x, g.to(x.dtype), b.to(x.dtype),
                                   (cfg.d_model,))


def _tok_rows(tok, tokens, tp_group):
    """The embedding rows of ``tokens``; with ``tp_group``, ``tok`` holds
    this rank's vocabulary rows: a masked local lookup summed over the
    group."""
    if tp_group is None:
        return tok[tokens]
    vl = tok.shape[0]
    local = tokens - dist.get_rank(tp_group) * vl
    inside = (local >= 0) & (local < vl)
    rows = tok[local.clamp(0, vl - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return comm.reduce_from_tp(rows, tp_group)


def embed(params: Params, tokens, pos_rows, cfg: TransformerConfig,
          tp_group=None):
    emb = params["embed"]
    with _trace.span("model.embed"):
        x = _tok_rows(emb["tok"], tokens, tp_group).to(cfg.dtype) \
            + pos_rows.to(cfg.dtype)
        return ln(x, emb["ln_g"], emb["ln_b"], cfg)


def _row_out(x, w, b, tp_group):
    """``x @ w + b`` of a row-split ``w``: the partial products summed over
    ``tp_group`` before the (replicated) bias."""
    dt = x.dtype
    out = x @ w.to(dt)
    if tp_group is not None:
        out = comm.reduce_from_tp(out, tp_group)
    return out + b.to(dt)


def mlp(x, lp, cfg: TransformerConfig, tp_group=None):
    """``x + ff2(gelu(ff1(ln2(x))))``; tanh gelu, as ``jax.nn.gelu``."""
    dt = x.dtype
    with _trace.span("model.mlp"):
        h = ln(x, lp["ln2_g"], lp["ln2_b"], cfg)
        if tp_group is not None:
            h = comm.copy_to_tp(h, tp_group)
        h = h @ lp["w1"].to(dt) + lp["b1"].to(dt)
        h = F.gelu(h, approximate="tanh")
        return x + _row_out(h, lp["w2"], lp["b2"], tp_group)


def head(params: Params, x, cfg: TransformerConfig, tp_group=None):
    """Logits ``(..., V)``; with ``tp_group``, this rank's vocabulary
    columns ``(..., V / tp)``."""
    dt = x.dtype
    with _trace.span("model.head"):
        x = ln(x, params["head"]["ln_g"], params["head"]["ln_b"], cfg)
        if tp_group is not None:
            x = comm.copy_to_tp(x, tp_group)
        w_out = (params["embed"]["tok"].t() if cfg.tie_embeddings
                 else params["head"]["out"]).to(dt)
        return x @ w_out


def qkv_heads(h, lp, cfg: TransformerConfig):
    """-> q, k, v each (B, S, H, hd); H is the heads ``lp`` holds (all of
    them, or a tensor-parallel rank's)."""
    B, S, _ = h.shape
    dt = h.dtype
    with _trace.span("attention.qkv"):
        qkv = h @ lp["wqkv"].to(dt) + lp["bqkv"].to(dt)
        width = qkv.shape[-1] // 3
        q, k, v = qkv.split(width, dim=-1)
        shape = (B, S, width // cfg.head_dim, cfg.head_dim)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def attention_core(q, k, v, cfg: TransformerConfig, mask=None, seed=0,
                   rate=0.0):
    """q, k, v (B, H, S, hd) -> ctx (B, H, S, hd).  ``mask``: optional
    key-padding mask (B, S), nonzero = PAD.  ``rate`` > 0: attention
    dropout with the counter-hash mask of ``seed``."""
    with _trace.span("attention.core"):
        B, H, S, hd = q.shape
        dt = q.dtype
        if cfg.attn_impl == "fast":
            from ..contrib.multihead_attn.flash import flash_attention
            scale = 1.0 / math.sqrt(hd)
            qf = (q.float() * scale).to(dt).reshape(B * H, S, hd) \
                .contiguous()
            if mask is not None:
                bias = torch.where(mask[:, None, :] != 0, -1e9, 0.0) \
                    .to(torch.float32)
            else:
                bias = torch.zeros((1, 1, S), dtype=torch.float32,
                                   device=q.device)
            ctx = flash_attention(qf, k.reshape(B * H, S, hd).contiguous(),
                                  v.reshape(B * H, S, hd).contiguous(),
                                  bias.contiguous(), seed=seed,
                                  causal=cfg.causal, dropout_rate=rate,
                                  heads=H)
            return ctx.reshape(B, H, S, hd)
        # JAX divides by sqrt(hd) in the activation dtype
        scores = (q @ k.transpose(-1, -2)) / torch.sqrt(
            torch.tensor(float(hd), dtype=dt, device=q.device))
        if cfg.causal:
            causal = torch.ones((S, S), dtype=torch.bool,
                                device=q.device).tril()
            scores = scores.masked_fill(~causal, float("-inf"))
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :] != 0, -1e9)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        if rate > 0.0:
            bh = torch.arange(B * H, device=q.device)[:, None, None]
            keep = _dropout_keep(seed, bh, 0, 0, (S, S), rate) \
                .view(B, H, S, S)
            probs = probs * keep.to(dt) / (1.0 - rate)
        return probs @ v


def attention(h, lp, cfg: TransformerConfig, mask=None, seed=0, rate=0.0,
              attn_override=None, tp_group=None):
    """Self-attention block output ``(B, S, D)`` plus this layer's k, v in
    (B, S, H, hd) (the layout the serving engine pages).

    ``attn_override``: a callable ``(q, k, v, *, causal) -> ctx`` over the
    (B, H, S, hd) layout that replaces the attention core, the hook the
    sequence-parallel engine (:mod:`apex_tpu_torch.parallel.spmd`) routes
    ring / Ulysses attention through.  It owns the 1/sqrt(hd) scaling; a
    key-padding mask does not compose with it and raises.  ``tp_group``:
    ``lp`` holds this rank's heads (see the module docstring)."""
    B, S, D = h.shape
    if tp_group is not None:
        h = comm.copy_to_tp(h, tp_group)
    q, k, v = qkv_heads(h, lp, cfg)
    if attn_override is not None:
        if mask is not None:
            raise ValueError(
                "attn_override does not compose with a key-padding mask "
                "(the sequence-parallel collectives carry no mask plumbing)")
        with _trace.span("attention.core"):
            ctx = attn_override(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=cfg.causal)
            ctx = ctx.to(h.dtype)
    else:
        ctx = attention_core(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), cfg, mask, seed, rate)
    with _trace.span("attention.out"):
        ctx = ctx.transpose(1, 2).reshape(B, S, -1)
        return _row_out(ctx, lp["wo"], lp["bo"], tp_group), k, v


def block(x, lp, cfg: TransformerConfig, mask=None, seed=0, rate=0.0,
          attn_override=None, tp_group=None):
    """One pre-LN layer: ``x + attn(ln1(x))``, then the MLP block."""
    with _trace.span("model.attention"):
        h = ln(x, lp["ln1_g"], lp["ln1_b"], cfg)
        out, _, _ = attention(h, lp, cfg, mask, seed, rate, attn_override,
                              tp_group)
        x = x + out
    return mlp(x, lp, cfg, tp_group)


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
                      attn_override=None, pos_offset: Optional[int] = None,
                      tp_group=None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) (with ``tp_group``, this
    rank's vocabulary columns, ``params`` its shards).  Pre-LN blocks, tied head.
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
    with _trace.span("model.embed"):
        pos_rows = params["embed"]["pos"][off:off + S][None]
        # one unbind per stacked leaf: its backward stacks the layer grads
        # once
        stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    x = embed(params, tokens, pos_rows, cfg, tp_group)
    n_layers = params["layers"]["wqkv"].shape[0]
    rate = cfg.dropout if dropout_rng is not None else 0.0
    for i, seed in enumerate(_layer_seeds(n_layers, dropout_rng)):
        lp = {k: v[i] for k, v in stacked.items()}
        fn = functools.partial(block, lp=lp, cfg=cfg, mask=mask, seed=seed,
                               rate=rate, attn_override=attn_override,
                               tp_group=tp_group)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        else:
            x = fn(x)
    return head(params, x, cfg, tp_group)


def transformer_loss(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: TransformerConfig, *,
                     dropout_rng: Optional[torch.Generator] = None,
                     smoothing: float = 0.0, attn_override=None,
                     pos_offset: Optional[int] = None,
                     tp_group=None) -> torch.Tensor:
    """Masked-LM cross-entropy through the fused xentropy kernel.  batch:
    ``tokens`` (B, S) int, ``targets`` (B, S) int, optional ``weights``
    (B, S) float and ``mask`` (B, S).  ``padding_idx=-1``: padding is
    expressed through ``weights``, and vocab id 0 is a legal target.
    ``attn_override`` / ``pos_offset`` thread through to
    :func:`transformer_apply` (sequence parallelism).  With ``tp_group``
    the loss is the vocab-parallel cross-entropy of the rank's logit
    columns (:func:`vocab_parallel_xentropy`), the same on every rank of
    the group."""
    from ..contrib.xentropy import softmax_xentropy_loss
    logits = transformer_apply(params, batch["tokens"], cfg,
                               mask=batch.get("mask"),
                               dropout_rng=dropout_rng,
                               attn_override=attn_override,
                               pos_offset=pos_offset, tp_group=tp_group)
    B, S, V = logits.shape
    with _trace.span("model.loss"):
        if tp_group is None:
            nll = softmax_xentropy_loss(logits.reshape(B * S, V),
                                        batch["targets"].reshape(B * S),
                                        smoothing, -1, False, cfg.xent_impl)
        else:
            nll = vocab_parallel_xentropy(logits.reshape(B * S, V),
                                          batch["targets"].reshape(B * S),
                                          tp_group, smoothing)
        nll = nll.reshape(B, S)
        w = batch.get("weights")
        if w is None:
            return nll.mean()
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


class _VocabParallelXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, smoothing, padding_idx):
        x = logits.float()
        vl = x.shape[-1]
        v = vl * dist.get_world_size(group)
        local = labels.long() - dist.get_rank(group) * vl
        inside = (local >= 0) & (local < vl)
        col = local.clamp(0, vl - 1)[:, None]
        m = comm.all_reduce_stat(x.amax(dim=-1), group, "max")
        e = torch.exp(x - m[:, None])
        lse = m + torch.log(comm.all_reduce_stat(e.sum(dim=-1), group))
        gold = torch.gather(x, 1, col)[:, 0]
        gold = comm.all_reduce_stat(
            torch.where(inside, gold, torch.zeros_like(gold)), group)
        smooth = torch.zeros_like(lse)
        if smoothing:
            smooth = lse - comm.all_reduce_stat(x.sum(dim=-1), group) / v
        loss = (1.0 - smoothing) * (lse - gold) + smoothing * smooth
        pad = labels == padding_idx
        ctx.save_for_backward(e, lse - m, col, inside, pad)
        ctx.args = (smoothing, v, logits.dtype)
        return torch.where(pad, torch.zeros_like(loss), loss)

    @staticmethod
    def backward(ctx, g):
        e, log_s, col, inside, pad = ctx.saved_tensors
        smoothing, v, dtype = ctx.args
        g = torch.where(pad, torch.zeros_like(g), g.float())
        grad = e * torch.exp(-log_s)[:, None] - smoothing / v
        gold = grad.gather(1, col) - (1.0 - smoothing) * inside[:, None]
        grad.scatter_(1, col, gold).mul_(g[:, None])
        return grad.to(dtype), None, None, None, None


def vocab_parallel_xentropy(logits, labels, group, smoothing: float = 0.0,
                            padding_idx: int = -1) -> torch.Tensor:
    """The cross-entropy of :func:`~apex_tpu_torch.contrib.xentropy.
    softmax_xentropy_loss` over logits whose vocabulary is split over
    ``group``: ``logits`` (N, V / tp) this rank's columns (rank ``r`` holds
    ``[r V / tp, (r + 1) V / tp)``), ``labels`` (N,) global ids.  The row
    maxima, sums of exponentials and gold logits are all-reduced, so
    every rank returns the same (N,) fp32 losses; the gradient is this
    rank's columns of softmax minus the one-hot."""
    return _VocabParallelXent.apply(logits, labels, group, float(smoothing),
                                    padding_idx)
