"""Inference engine: prefill + paged single-token decode steps, with
inference O-levels.

Counterpart of ``apex_tpu/serve/engine.py``.  Two steps serve every request:

  * **prefill** — one request at a time, the full-prompt forward at a
    FIXED width of ``cache.max_ctx`` (prompt right-padded with token 0),
    causal.  Along the way it captures every layer's K/V and writes them
    into the request's pages.  ``attn_impl="fast"`` runs the attention
    core on the flash kernel.  Only the prompt's last row goes through the
    head (the JAX engine computes every row and slices one).
  * **decode** — a fixed batch of ``decode_width`` single tokens, one per
    continuous-batching slot.  Each slot's K/V for its new token is written
    into its current page, then attention gathers the slot's whole page
    table back into a contiguous ``(max_ctx,)`` key window and masks
    positions beyond the slot's context to -inf — stale or scratch pages
    contribute exactly 0, so mid-flight eviction and page recycling are
    invisible to surviving slots.

With ``mesh=`` (a named mesh with a ``model`` axis) the engine is
tensor-parallel: each rank holds its Megatron shards of the weights
(:func:`~apex_tpu_torch.models.transformer.tp_shard_params`) and its
heads' slice of the KV pools, ``(L, pages, page_size, H / tp, hd)``;
prefill runs flash on its heads, decode attends over them, the row
products are summed over the axis, and the vocabulary-split logits are
gathered whole, so every rank samples the same tokens from the same bits.
The int8 O-level keeps its packed codes whole on every rank and takes the
rank's shards after the dequantize.

Every layer norm on both steps runs on the layer-norm kernel.  The pools
are updated in place (the JAX engine threads new pool arrays through each
step; in place saves a pool-sized copy per step).  Steps run under
``torch.inference_mode()`` and return device tensors without syncing; the
scheduler batches them into its one host read per step.

Inference O-levels:

    fp32   everything float32 (the numerics oracle)
    bf16   weights + activations bf16
    int8   every float leaf of two or more dimensions stored as block-scaled
           int8 codes (the codec of :mod:`~apex_tpu_torch.parallel.
           collectives`: one fp32 scale per 128 elements) and dequantized
           to bf16 when a step reads it; one-dimensional float leaves
           stored as bf16; compute in bf16.  ``compression_ratio`` (fp32
           bytes over stored bytes, ~3.9) goes to the serve ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import transformer as tm
from ..models.transformer import TransformerConfig, tp_shard_params
from ..parallel import comm
from ..parallel.mesh import MODEL_AXIS
from ..utils.device import resolve_device
from ..utils.pytree import tree_flatten, tree_unflatten
from .cache import CacheConfig
from .sample import request_key, sample_batch, sample_token

__all__ = ["OLEVELS", "InferenceEngine", "prepare_olevel"]

OLEVELS = ("fp32", "bf16", "int8")

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _cast_floats(params, dtype: torch.dtype):
    """Cast floating leaves of a nested dict to ``dtype``; integer leaves
    pass through."""
    if isinstance(params, dict):
        return {k: _cast_floats(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def prepare_olevel(params, olevel: str):
    """-> (packed_params, unpack_fn, compute_dtype, compression_ratio), the
    JAX signature.  ``unpack_fn(packed)`` runs inside each step and gives
    the parameter tree in the compute dtype (int8's dequantize-on-read
    point); it is the identity for fp32 and bf16.  ``compression_ratio`` is
    fp32 bytes over stored bytes, None below int8."""
    if olevel not in OLEVELS:
        raise ValueError(f"olevel must be one of {OLEVELS}, got {olevel!r}")
    if olevel != "int8":
        dt = _DTYPES[olevel]
        return _cast_floats(params, dt), (lambda p: p), dt, None

    from ..parallel.collectives import (dequantize_blockscale,
                                        quantize_blockscale)
    leaves, treedef = tree_flatten(params)
    packed, meta = [], []
    bytes_fp32 = bytes_stored = 0
    for leaf in leaves:
        isf = leaf.is_floating_point()
        bytes_fp32 += leaf.numel() * (4 if isf else leaf.element_size())
        if isf and leaf.dim() >= 2:
            q, scales = quantize_blockscale(
                leaf.to(torch.float32).reshape(-1))
            packed.append((q, scales))
            meta.append(("q", tuple(leaf.shape), leaf.numel()))
            bytes_stored += q.numel() + scales.numel() * 4
        elif isf:
            cast = leaf.to(torch.bfloat16)
            packed.append(cast)
            meta.append(("raw", None, None))
            bytes_stored += cast.numel() * 2
        else:
            packed.append(leaf)
            meta.append(("raw", None, None))
            bytes_stored += leaf.numel() * leaf.element_size()

    def unpack(packed_leaves):
        out = []
        for entry, (kind, shape, n) in zip(packed_leaves, meta):
            if kind == "q":
                q, scales = entry
                out.append(dequantize_blockscale(q, scales, n).reshape(
                    shape).to(torch.bfloat16))
            else:
                out.append(entry)
        return tree_unflatten(treedef, out)

    return packed, unpack, torch.bfloat16, \
        bytes_fp32 / max(bytes_stored, 1)


class InferenceEngine:
    """Owns the KV pools and the two steps.  All device work, no host
    syncs: both steps return device tensors.  ``mesh``: a named mesh
    whose ``model`` axis makes the engine tensor-parallel (the module
    docstring); every rank of the axis serves the same requests."""

    def __init__(self, params, model_cfg: TransformerConfig, *,
                 cache: Optional[CacheConfig] = None,
                 olevel: str = "bf16", decode_width: int = 4,
                 device=None, mesh=None):
        cache = cache or CacheConfig()
        if decode_width < 2:
            raise ValueError(
                "decode_width must be >= 2 (the JAX engine's floor, kept so "
                "both engines serve the same configurations)")
        if cache.max_ctx > model_cfg.max_len:
            raise ValueError(f"cache.max_ctx {cache.max_ctx} exceeds "
                             f"model max_len {model_cfg.max_len}")
        if model_cfg.num_heads * model_cfg.head_dim != model_cfg.d_model:
            raise ValueError("d_model must equal num_heads * head_dim")
        self.device = resolve_device(device)
        self.cache = cache
        self.decode_width = int(decode_width)
        self.olevel = str(olevel)
        self.mesh = mesh
        self.tp_group, rank, tp = None, 0, 1
        if mesh is not None and MODEL_AXIS in mesh.shape:
            from ..parallel.spmd import serve_shardings
            serve_shardings(mesh, model_cfg, packed=params)
            self.tp_group = mesh.group(MODEL_AXIS)
            rank, tp = mesh.axis_index(MODEL_AXIS), mesh.shape[MODEL_AXIS]
        on_dev = {k: {n: t.to(self.device) for n, t in v.items()}
                  for k, v in params.items()}
        if self.tp_group is not None and olevel != "int8":
            on_dev = tp_shard_params(on_dev, model_cfg, rank, tp)
        self._packed, unpack, dt, self.compression_ratio = \
            prepare_olevel(on_dev, olevel)
        if self.tp_group is not None and olevel == "int8":
            # the codes stay whole; each step slices the dequantized tree
            def unpack(packed, _whole=unpack):
                return tp_shard_params(_whole(packed), model_cfg, rank, tp)
        self._unpack = unpack
        self.cfg = dataclasses.replace(model_cfg, dtype=dt, causal=True,
                                       dropout=0.0)
        L, hd = self.cfg.num_layers, self.cfg.head_dim
        self.heads = self.cfg.num_heads // tp
        pool_shape = (L, cache.num_pages, cache.page_size, self.heads, hd)
        self.k_pool = torch.zeros(pool_shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(pool_shape, dtype=dt, device=self.device)
        self.prefills = 0        # steps run, for launch-count checks
        self.decode_steps = 0

    def _logits(self, params, x):
        """The head's logits, whole: a tensor-parallel rank's vocabulary
        columns gathered over the axis in rank order (the same bits on
        every rank)."""
        logits = tm.head(params, x, self.cfg, self.tp_group)
        if self.tp_group is None:
            return logits
        return comm.gather_from_tp(logits, self.tp_group, -1)

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(
            self.device, non_blocking=True)

    # -- public surface (device out; no syncs) -------------------------------
    @torch.inference_mode()
    def prefill(self, tokens, prompt_len: int, page_table, seed: int,
                temperature: float = 0.0, top_k: int = 0):
        """Run one request's prompt through the fixed-width prefill.
        ``tokens``: (max_ctx,) ints, right-padded with 0; ``page_table``:
        (pages_per_request,) pool pages.  Returns (first_token, last_logits)
        device tensors; the pools are updated."""
        cfg, cache = self.cfg, self.cache
        params = self._unpack(self._packed)
        S, PPR, PS = cache.max_ctx, cache.pages_per_request, cache.page_size
        plen = int(prompt_len)
        if not 0 < plen <= S:
            raise ValueError(f"prompt_len {plen} outside (0, {S}]")
        toks = self._tensor(tokens, torch.long)[None]              # (1, S)
        table = self._tensor(page_table, torch.long)
        tp = self.tp_group
        x = tm.embed(params, toks, params["embed"]["pos"][:S][None], cfg, tp)
        for i in range(cfg.num_layers):
            lp = tm.layer(params, i)
            h = tm.ln(x, lp["ln1_g"], lp["ln1_b"], cfg)
            out, k, v = tm.attention(h, lp, cfg, tp_group=tp)
            # whole-page write of this layer's (S, H, hd) into the pages
            self.k_pool[i, table] = k[0].reshape(PPR, PS, *k.shape[2:])
            self.v_pool[i, table] = v[0].reshape(PPR, PS, *v.shape[2:])
            x = tm.mlp(x + out, lp, cfg, tp)
        last = self._logits(params, x[:, plen - 1])[0]             # (V,)
        first = sample_token(last, request_key(seed, plen),
                             float(temperature), int(top_k))
        self.prefills += 1
        return first, last

    @torch.inference_mode()
    def decode_step(self, tokens, positions, page_tables, seeds,
                    temperatures, top_ks):
        """One continuous-batching decode step over all slots.  Every arg
        is (W,)-shaped host per-slot state ((W, PPR) for the tables).
        Returns (next_tokens (W,), logits (W, V)) device tensors; the
        pools are updated."""
        cfg, cache = self.cfg, self.cache
        params = self._unpack(self._packed)
        W, S, PS = self.decode_width, cache.max_ctx, cache.page_size
        H, hd, tp = self.heads, cfg.head_dim, self.tp_group
        pos_host = np.asarray(positions, np.int64)
        toks = self._tensor(tokens, torch.long)
        pos = self._tensor(pos_host, torch.long)
        tables = self._tensor(page_tables, torch.long)             # (W, PPR)
        pages = tables.gather(1, (pos // PS)[:, None])[:, 0]
        slots = pos % PS
        x = tm.embed(params, toks[:, None],
                     params["embed"]["pos"][pos][:, None], cfg, tp)  # (W,1,D)
        valid = torch.arange(S, device=self.device)[None, None, None, :] \
            <= pos[:, None, None, None]                            # (W,1,1,S)
        scale = torch.sqrt(torch.tensor(float(hd), dtype=cfg.dtype,
                                        device=self.device))
        for i in range(cfg.num_layers):
            lp = tm.layer(params, i)
            h = tm.ln(x, lp["ln1_g"], lp["ln1_b"], cfg)
            q, k, v = tm.qkv_heads(h, lp, cfg)                     # (W,1,H,hd)
            kp, vp = self.k_pool[i], self.v_pool[i]
            kp[pages, slots] = k[:, 0]
            vp[pages, slots] = v[:, 0]
            # gather-over-pages: each slot's table back to a contiguous
            # (max_ctx,) key window
            kg = kp[tables].reshape(W, S, H, hd).transpose(1, 2)   # (W,H,S,hd)
            vg = vp[tables].reshape(W, S, H, hd).transpose(1, 2)
            scores = (q.transpose(1, 2) @ kg.transpose(-1, -2)) / scale
            scores = scores.masked_fill(~valid, float("-inf"))
            probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
            ctx = (probs @ vg).transpose(1, 2).reshape(W, 1, H * hd)
            out = tm._row_out(ctx, lp["wo"], lp["bo"], tp)
            x = tm.mlp(x + out, lp, cfg, tp)
        logits = self._logits(params, x)[:, 0]                     # (W, V)
        toks_out = sample_batch(logits, seeds, pos_host + 1, temperatures,
                                top_ks)
        self.decode_steps += 1
        return toks_out, logits
