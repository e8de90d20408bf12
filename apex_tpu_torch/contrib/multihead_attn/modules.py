"""``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` as ``nn.Module``\\ s.

Counterpart of ``apex_tpu/contrib/multihead_attn/modules.py`` (the
reference's ``self_multihead_attn.py`` / ``encdec_multihead_attn.py``).  The
JAX modules are config objects over a parameter dict; here each module owns
``nn.Parameter``\\ s under the JAX dict's names and layouts
(``in_proj_weight`` (3E, E) or ``q_weight`` / ``k_weight`` / ``v_weight``,
``out_proj_weight``, the biases, ``lyr_nrm_gamma_weights`` /
``lyr_nrm_beta_weights``; encdec's ``in_proj_weight_q`` (E, E) and
``in_proj_weight_kv`` (2E, E)), so :func:`mha_params_from_jax` of a JAX
dict loads with ``load_state_dict``.

``impl="fast"`` runs :func:`~apex_tpu_torch.contrib.multihead_attn.flash.
flash_attention` (the flash forward kernel and the fused backward kernel,
or the split pair past the fuse cap); ``impl="default"`` the plain
:func:`~apex_tpu_torch.contrib.multihead_attn.functional.attention_core`.
``include_norm_add`` puts the layer-norm kernels
(:func:`~apex_tpu_torch.normalization.fused_layer_norm_affine`) in front
and adds the residual.  ``SelfMultiheadAttn``'s ``impl="ring"`` /
``"ulysses"`` run sequence parallelism
(:mod:`apex_tpu_torch.parallel.sequence`): the (T, B, C) input is this
rank's block of the sequence over ``seq_parallel_axis`` (a mesh axis name
or a process group), causality is the constructor's ``causal`` flag (a
per-call mask cannot express global structure under sequence sharding, so
masks and attention dropout raise), and ``seq_inner_impl="fast"`` runs
Ulysses' gathered-sequence core on the flash kernels.

Dropout: with no ``dropout_rng`` there is no dropout on any impl.
``dropout_rng`` is a ``torch.Generator`` or an int.  The fast path's kernel
seed is the int itself, or one int32 drawn from the generator; the int is
what the JAX package's ``_rng_seed_from`` gives for a key, so both packages
then apply the same counter-hash mask.  The default path's and the residual
dropout's masks come from :func:`~apex_tpu_torch.contrib.multihead_attn.
functional.bernoulli_keep` (the residual's from the int + 1 for an int, as
the JAX package folds 1 into its key); their bits are not the JAX
package's ``jax.random`` bits.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from ...normalization.fused_layer_norm import fused_layer_norm_affine
from ...utils.device import from_numpy, resolve_device
from .flash import BACKWARD_IMPLS, flash_attention
from .functional import (Rng, attention_core, bernoulli_keep, build_bias,
                         draw_seed, _merge_heads, _split_heads)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn", "mha_params_from_jax",
           "_is_causal_mask"]


def _xavier_uniform(gen, shape, gain=1.0) -> torch.Tensor:
    fan_in, fan_out = shape[1], shape[0]
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-a, a,
                                                           generator=gen)


def _is_causal_mask(mask) -> bool:
    """True when an (S, S) time mask is exactly the strict upper triangle:
    the kernels then take their causal route (zero bias, ``causal=True``)
    instead of streaming an (S, S) bias.  A mask on the card is compared
    there and the answer read back once (one synchronization)."""
    if mask is None or mask.dim() != 2 or mask.shape[0] != mask.shape[1]:
        return False
    upper = torch.ones(mask.shape, dtype=torch.bool,
                       device=mask.device).triu(1)
    return bool(torch.equal(mask.bool(), upper))


def _pick_mask(key_padding_mask, attn_mask):
    """(mask, use_time_mask): the key-padding mask wins, as in the JAX
    modules."""
    if key_padding_mask is not None:
        return key_padding_mask, False
    if attn_mask is not None:
        return attn_mask, True
    return None, False


def _check_backward(backward):
    if backward not in BACKWARD_IMPLS:
        raise AssertionError(f"Unsupported backward: {backward!r} (one of "
                             f"{BACKWARD_IMPLS})")


def _rngs(dropout_rng: Rng):
    """(attention rng, residual rng) of one call."""
    if isinstance(dropout_rng, int):
        return dropout_rng, dropout_rng + 1
    return dropout_rng, dropout_rng


def _norm_params(module, E, dev):
    module.lyr_nrm_gamma_weights = nn.Parameter(
        torch.ones(E, dtype=torch.float32, device=dev))
    module.lyr_nrm_beta_weights = nn.Parameter(
        torch.zeros(E, dtype=torch.float32, device=dev))


class _MHABase(nn.Module):
    """What both modules share: the attention call of either impl, the
    output projection and the norm-add residual."""

    def _attend(self, q, k, v, mask, use_time_mask, mask_additive, drop,
                rng):
        """q (B, H, Sq, D) pre-scaled, k/v (B, H, Sk, D) -> (B, H, Sq, D)."""
        B, H, Sq, D = q.shape
        Sk = k.shape[2]
        bias = build_bias(mask, mask_additive, batch=B, sq=Sq, sk=Sk,
                          use_time_mask=use_time_mask, device=q.device)
        if self.impl != "fast":
            return attention_core(q, k, v, bias, dropout_rate=drop,
                                  dropout_rng=rng, heads=H)
        causal = use_time_mask and _is_causal_mask(mask)
        if causal:
            bias = torch.zeros((1, 1, Sk), dtype=torch.float32,
                               device=q.device)
        bias = torch.nan_to_num(bias.detach(), neginf=-1e30).contiguous()
        if rng is None or drop == 0.0:
            seed = 0
        elif isinstance(rng, torch.Generator):
            seed = draw_seed(rng)
        else:
            seed = int(rng)
        # the kernels take contiguous (BH, S, D) operands: the heads'
        # permuted views are copied here, once each
        ctx = flash_attention(q.reshape(B * H, Sq, D).contiguous(),
                              k.reshape(B * H, Sk, D).contiguous(),
                              v.reshape(B * H, Sk, D).contiguous(), bias,
                              seed, causal, drop, H, self.backward)
        return ctx.reshape(B, H, Sq, D)

    def _finish(self, ctx, residual, is_training, rng, out_bias=None):
        """Output projection, then (norm-add) residual dropout + add."""
        Sq, B, E = residual.shape
        out = torch.matmul(_merge_heads(ctx).reshape(Sq * B, E),
                           self.out_proj_weight.t().to(ctx.dtype))
        if out_bias is not None:
            out = out + out_bias.to(out.dtype)
        out = out.reshape(Sq, B, E)
        if self.include_norm_add:
            if is_training and self.dropout > 0.0 and rng is not None:
                keep = bernoulli_keep(out.shape, 1.0 - self.dropout, rng,
                                      out.device)
                out = out * keep.to(out.dtype) / (1.0 - self.dropout)
            out = residual + out
        return out

    def _layer_norm(self, x):
        E = x.shape[-1]
        return fused_layer_norm_affine(
            x, self.lyr_nrm_gamma_weights.to(x.dtype),
            self.lyr_nrm_beta_weights.to(x.dtype), (E,))


class SelfMultiheadAttn(_MHABase):
    """Self-attention over (T, B, C) inputs with the reference's options:
    ``bias``, ``include_norm_add``, ``separate_qkv_params``,
    ``mask_additive``; ``impl`` "fast" (the flash kernels), "default"
    (plain PyTorch), or "ring" / "ulysses" (sequence parallelism over
    ``seq_parallel_axis``, causal by ``causal``; ``seq_inner_impl="fast"``
    puts Ulysses' core on the flash kernels); ``backward`` "auto" / "pallas" (the backward kernels)
    or "xla" (autograd of the plain forward).  Parameters are fp32, drawn
    from ``generator`` (default torch's global one) by the JAX package's
    Xavier rule, on ``device`` (default ``"cuda"``).

    ``separate_qkv_params`` keeps the JAX package's assembly: q, k and v
    rows interleave per head into one (3E, E) matrix (H, 3, D, E), which
    the call then splits as (3, E) blocks, so the "q" it attends with mixes
    the first heads' q, k and v rows (ROADMAP.md, Queue 3)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 separate_qkv_params=False, mask_additive=False,
                 seq_parallel_axis="seq", causal=False,
                 seq_inner_impl="default", backward="auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise AssertionError("embed_dim must be divisible by num_heads")
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.scaling = self.head_dim ** -0.5
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive = mask_additive
        self.seq_parallel_axis = seq_parallel_axis
        self.causal = causal        # ring / ulysses only (global causality)
        self.seq_inner_impl = seq_inner_impl
        self.backward = backward
        if mask_additive and include_norm_add:
            raise AssertionError("additive mask not supported with layer norm")
        if impl not in ("fast", "default", "ring", "ulysses"):
            raise AssertionError(f"Unsupported impl: {impl} !")
        _check_backward(backward)
        if seq_inner_impl not in ("default", "fast"):
            raise AssertionError(
                f"Unsupported seq_inner_impl: {seq_inner_impl} !")
        if seq_inner_impl == "fast" and impl != "ulysses":
            raise AssertionError(
                "seq_inner_impl='fast' applies to impl='ulysses' only")

        dev = resolve_device(device)
        gen = generator if generator is not None else torch.default_generator
        E = embed_dim

        def param(t):
            return nn.Parameter(t.to(dev))
        if separate_qkv_params:
            self.q_weight = param(_xavier_uniform(gen, (E, E)))
            self.k_weight = param(_xavier_uniform(gen, (E, E)))
            self.v_weight = param(_xavier_uniform(gen, (E, E)))
        else:
            # gain sqrt(2): (3E, E) initialized like (E, E)
            self.in_proj_weight = param(_xavier_uniform(gen, (3 * E, E),
                                                        gain=math.sqrt(2)))
        self.out_proj_weight = param(_xavier_uniform(gen, (E, E)))
        if bias:
            if separate_qkv_params:
                self.q_bias = param(torch.zeros(E))
                self.k_bias = param(torch.zeros(E))
                self.v_bias = param(torch.zeros(E))
            else:
                self.in_proj_bias = param(torch.zeros(3 * E))
            self.out_proj_bias = param(torch.zeros(E))
        if include_norm_add:
            _norm_params(self, E, dev)

    def _attend_seq(self, q, k, v, mask, drop):
        """The sequence-parallel core: q (pre-scaled), k, v this rank's
        (B, H, S_local, D) blocks."""
        if drop > 0.0:
            raise NotImplementedError(
                f"impl={self.impl!r} does not support attention dropout")
        if mask is not None:
            raise NotImplementedError(
                f"impl={self.impl!r} takes causality from the constructor "
                "causal= flag; per-call masks are unsupported")
        from ...parallel.sequence import (ring_attention, ulysses_attention,
                                          ulysses_flash_attention)
        if self.impl == "ring":
            seq_fn = ring_attention
        elif self.seq_inner_impl == "fast":
            seq_fn = functools.partial(ulysses_flash_attention,
                                       backward=self.backward)
        else:
            seq_fn = ulysses_attention
        return seq_fn(q, k, v, axis_name=self.seq_parallel_axis,
                      causal=self.causal, scale=1.0)

    def _input_weights(self):
        """(3E, E) weight and (3E,) bias or None; separate q/k/v interleave
        per head as in the JAX package."""
        if not self.separate_qkv_params:
            return self.in_proj_weight, getattr(self, "in_proj_bias", None)
        E, H, D = self.embed_dim, self.num_heads, self.head_dim
        w = torch.stack([self.q_weight.reshape(H, D, E),
                         self.k_weight.reshape(H, D, E),
                         self.v_weight.reshape(H, D, E)], dim=1
                        ).reshape(3 * E, E)
        b = None
        if self.bias:
            b = torch.stack([self.q_bias.reshape(H, D),
                             self.k_bias.reshape(H, D),
                             self.v_bias.reshape(H, D)], dim=1).reshape(3 * E)
        return w, b

    def forward(self, query, key=None, value=None, *, key_padding_mask=None,
                need_weights=False, attn_mask=None, is_training=True,
                dropout_rng: Rng = None):
        """query (T, B, C); ``key`` and ``value`` are ignored (q = k = v)
        and so is ``need_weights``.  Returns ``(output, None)``."""
        del key, value, need_weights
        if key_padding_mask is not None and attn_mask is not None:
            raise AssertionError(
                "attn_mask and key_padding_mask should not be both defined!")
        if attn_mask is not None and self.mask_additive:
            raise AssertionError("additive mask not supported for time mask")
        mask, use_time_mask = _pick_mask(key_padding_mask, attn_mask)

        in_w, in_b = self._input_weights()
        S, B, E = query.shape
        x = self._layer_norm(query) if self.include_norm_add else query
        lin = torch.matmul(x.reshape(S * B, E), in_w.t().to(x.dtype))
        if in_b is not None:
            lin = lin + in_b.to(lin.dtype)
        lin = lin.reshape(S, B, 3, E)
        q = _split_heads(lin[:, :, 0, :], self.num_heads) * self.scaling
        k = _split_heads(lin[:, :, 1, :], self.num_heads)
        v = _split_heads(lin[:, :, 2, :], self.num_heads)

        drop = self.dropout if is_training and dropout_rng is not None \
            else 0.0
        attn_rng, resid_rng = _rngs(dropout_rng)
        if self.impl in ("ring", "ulysses"):
            ctx = self._attend_seq(q, k, v, mask, drop)
        else:
            ctx = self._attend(q, k, v, mask, use_time_mask,
                               self.mask_additive, drop, attn_rng)
        out = self._finish(ctx, query, is_training, resid_rng,
                           getattr(self, "out_proj_bias", None))
        return out, None


class EncdecMultiheadAttn(_MHABase):
    """Encoder-decoder attention: Q from the decoder stream (T, B, C), a
    fused KV projection (2E, E) of the encoder stream ``key`` (S, B, C).
    Options and parameters as :class:`SelfMultiheadAttn`; the reference
    module has no projection biases."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast", backward="auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if bias:
            raise AssertionError(
                "additive bias not supported by the reference encdec module")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise AssertionError("embed_dim must be divisible by num_heads")
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.scaling = self.head_dim ** -0.5
        self.backward = backward
        if impl not in ("fast", "default"):
            raise AssertionError(f"Unsupported impl: {impl} !")
        _check_backward(backward)

        dev = resolve_device(device)
        gen = generator if generator is not None else torch.default_generator
        E = embed_dim
        self.in_proj_weight_q = nn.Parameter(
            _xavier_uniform(gen, (E, E)).to(dev))
        self.in_proj_weight_kv = nn.Parameter(
            _xavier_uniform(gen, (2 * E, E), gain=math.sqrt(2)).to(dev))
        self.out_proj_weight = nn.Parameter(
            _xavier_uniform(gen, (E, E)).to(dev))
        if include_norm_add:
            _norm_params(self, E, dev)

    def forward(self, query, key, value=None, *, key_padding_mask=None,
                need_weights=False, attn_mask=None, is_training=True,
                dropout_rng: Rng = None):
        """query (T, B, C), key (S, B, C) the encoder output (k and v both
        come from it; ``value`` and ``need_weights`` are ignored).  Returns
        ``(output, None)``."""
        del value, need_weights
        mask, use_time_mask = _pick_mask(key_padding_mask, attn_mask)
        Sq, B, E = query.shape
        Sk = key.shape[0]
        H = self.num_heads
        x = self._layer_norm(query) if self.include_norm_add else query
        q = torch.matmul(x.reshape(Sq * B, E),
                         self.in_proj_weight_q.t().to(x.dtype)
                         ).reshape(Sq, B, E)
        kv = torch.matmul(key.reshape(Sk * B, E),
                          self.in_proj_weight_kv.t().to(key.dtype)
                          ).reshape(Sk, B, 2, E)
        qh = _split_heads(q, H) * self.scaling
        kh = _split_heads(kv[:, :, 0, :], H)
        vh = _split_heads(kv[:, :, 1, :], H)

        drop = self.dropout if is_training and dropout_rng is not None \
            else 0.0
        attn_rng, resid_rng = _rngs(dropout_rng)
        ctx = self._attend(qh, kh, vh, mask, use_time_mask, False, drop,
                           attn_rng)
        return self._finish(ctx, query, is_training, resid_rng), None


def mha_params_from_jax(params) -> dict:
    """A JAX module's parameter dict (``init_params``; numpy arrays or
    anything ``np.asarray`` takes) -> CPU tensors under the same names,
    for ``load_state_dict``."""
    return from_numpy(dict(params), "cpu")
