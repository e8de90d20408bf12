"""DCGAN generator and discriminator: the two-optimizer, three-scaler amp
workload of the dcgan example (BASELINE config 5).

Counterpart of ``apex_tpu/models/dcgan.py``.  Parameters and batch-norm
state are nested dicts with the JAX package's tree paths, letter for letter
(``gen.deconv0..4``, ``gen.bn0..3``, ``disc.conv0..4``, ``disc.bn1..3``;
batch-norm leaves ``scale`` / ``bn_bias`` and state ``mean`` / ``var``).
Images are NHWC at the boundary, as in the JAX functions; inside, each
activation is a logical-NCHW tensor in channels_last memory (NHWC bytes,
cuDNN's tensor-core layout), and each batch norm is the port's
:func:`~apex_tpu_torch.parallel.sync_batch_norm` with ``axis_name=()``:
per-device statistics, as the JAX model's plain batch norm.

Weights are stored in the layouts the torch convolutions take, converted
from the JAX package's HWIO by :func:`dcgan_params_from_jax`:

- ``conv*``: OIHW, channels_last;
- ``deconv*``: (in, out, kh, kw) with the spatial taps reversed.  The JAX
  model's ``lax.conv_transpose(..., transpose_kernel=False)`` applies its
  HWIO kernel unflipped to the stride-dilated input, while
  ``F.conv_transpose2d`` is the gradient of a convolution and so applies
  its kernel flipped: ``flip(w_hwio, (0, 1)).permute(2, 3, 0, 1)`` makes
  the two agree.  The JAX "SAME" at k 4, stride 2 pads the dilated input
  by (2, 2), which is ``padding=1``; deconv0's "VALID" is ``padding=0``.

The discriminator's stride-2 "SAME" convolutions on even sizes pad (1, 1),
symmetric, so ``F.conv2d``'s ``padding=1`` is XLA's pad.  Every call is
the namespace function the JAX model calls (``F.conv_transpose2d`` for
``lax.conv_transpose``, ``F.conv2d`` for ``lax.conv_general_dilated``,
``torch.mean`` for ``jnp.mean``), so the O4 casts apply where they apply
in the JAX model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..parallel.sync_batchnorm import sync_batch_norm
from ..utils.device import from_numpy, resolve_device
from .resnet import _conv_weight as conv_weight   # HWIO -> OIHW, NHWC

__all__ = ["DCGANConfig", "dcgan_init", "generator_apply",
           "discriminator_apply", "dcgan_params_from_jax",
           "deconv_weight", "conv_weight"]


@dataclasses.dataclass(frozen=True)
class DCGANConfig:
    latent_dim: int = 100
    feat_g: int = 64
    feat_d: int = 64
    channels: int = 3
    dtype: Any = torch.float32           # activation and weight dtype


def deconv_weight(hwio: torch.Tensor) -> torch.Tensor:
    """A JAX ``conv_transpose`` HWIO kernel as ``F.conv_transpose2d``
    takes it: taps reversed, (in, out, kh, kw), channels_last."""
    return torch.flip(hwio, (0, 1)).permute(2, 3, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _bn_pair(c):
    return ({"scale": torch.ones(c), "bn_bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def dcgan_init(generator: torch.Generator, cfg: DCGANConfig, device=None):
    """(params, bn_state): every kernel N(0, 0.02) (the example's
    ``weights_init``), drawn as HWIO on the CPU from ``generator``, the
    generator's first, so a seed gives the same weights on every device;
    batch norm 1 / 0 with running mean 0, var 1; all fp32 on ``device``
    (default ``"cuda"``)."""
    dev = resolve_device(device)
    fg, fd, C, Z = cfg.feat_g, cfg.feat_d, cfg.channels, cfg.latent_dim

    def w(shape):
        return 0.02 * torch.randn(*shape, generator=generator)

    gen = {"deconv0": deconv_weight(w((4, 4, Z, fg * 8))),
           "deconv1": deconv_weight(w((4, 4, fg * 8, fg * 4))),
           "deconv2": deconv_weight(w((4, 4, fg * 4, fg * 2))),
           "deconv3": deconv_weight(w((4, 4, fg * 2, fg))),
           "deconv4": deconv_weight(w((4, 4, fg, C)))}
    gstate = {}
    for i, c in enumerate([fg * 8, fg * 4, fg * 2, fg]):
        gen[f"bn{i}"], gstate[f"bn{i}"] = _bn_pair(c)
    disc = {"conv0": conv_weight(w((4, 4, C, fd))),
            "conv1": conv_weight(w((4, 4, fd, fd * 2))),
            "conv2": conv_weight(w((4, 4, fd * 2, fd * 4))),
            "conv3": conv_weight(w((4, 4, fd * 4, fd * 8))),
            "conv4": conv_weight(w((4, 4, fd * 8, 1)))}
    dstate = {}
    for i, c in enumerate([fd * 2, fd * 4, fd * 8]):
        disc[f"bn{i + 1}"], dstate[f"bn{i + 1}"] = _bn_pair(c)

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        return t.to(dev)
    return move({"gen": gen, "disc": disc}), move({"gen": gstate,
                                                   "disc": dstate})


def dcgan_params_from_jax(params_np, bn_state_np, device=None):
    """The JAX package's ``(params, bn_state)`` (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's, on ``device`` (default
    ``"cuda"``): the same trees and values, each kernel in the layout
    above."""
    params = from_numpy(params_np, device)
    gen = {k: deconv_weight(v) if k.startswith("deconv") else v
           for k, v in params["gen"].items()}
    disc = {k: conv_weight(v) if k.startswith("conv") else v
            for k, v in params["disc"].items()}
    return {"gen": gen, "disc": disc}, from_numpy(bn_state_np, device)


def _bn(x, p, s, train):
    out, m, v = sync_batch_norm(x, p["scale"], p["bn_bias"], s["mean"],
                                s["var"], axis_name=(), training=train,
                                channel_last=False)
    return out, ({"mean": m, "var": v} if train else s)


def generator_apply(params, bn_state, z, cfg: DCGANConfig, *, train=True):
    """z (N, latent) -> (images (N, 64, 64, C) in [-1, 1], new_bn_state);
    the images in ``cfg.dtype``."""
    g, gs = params["gen"], bn_state["gen"]
    ns = dict(gs)
    dt = cfg.dtype
    x = z.reshape(z.shape[0], cfg.latent_dim, 1, 1).to(dt)
    x = F.conv_transpose2d(x, g["deconv0"].to(dt))             # 4 x 4
    x, ns["bn0"] = _bn(x, g["bn0"], gs["bn0"], train)
    x = torch.relu(x)
    for i, name in enumerate(["deconv1", "deconv2", "deconv3"]):
        x = F.conv_transpose2d(x, g[name].to(dt), stride=2,
                               padding=1)                       # 8, 16, 32
        x, ns[f"bn{i + 1}"] = _bn(x, g[f"bn{i + 1}"], gs[f"bn{i + 1}"],
                                  train)
        x = torch.relu(x)
    x = F.conv_transpose2d(x, g["deconv4"].to(dt), stride=2,
                           padding=1)                           # 64 x 64
    return torch.tanh(x).permute(0, 2, 3, 1), {**bn_state, "gen": ns}


def discriminator_apply(params, bn_state, img, cfg: DCGANConfig, *,
                        train=True):
    """img (N, 64, 64, C) -> (logits (N,) fp32, new_bn_state).  The logits
    are pre-sigmoid (BCE with logits, as the JAX model)."""
    d, ds = params["disc"], bn_state["disc"]
    ns = dict(ds)
    dt = cfg.dtype
    x = img.to(dt).permute(0, 3, 1, 2)           # NCHW view of NHWC memory
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.conv2d(x, d["conv0"].to(dt), stride=2, padding=1)
    x = F.leaky_relu(x, 0.2)
    for i, name in enumerate(["conv1", "conv2", "conv3"]):
        x = F.conv2d(x, d[name].to(dt), stride=2, padding=1)
        x, ns[f"bn{i + 1}"] = _bn(x, d[f"bn{i + 1}"], ds[f"bn{i + 1}"],
                                  train)
        x = F.leaky_relu(x, 0.2)
    x = F.conv2d(x, d["conv4"].to(dt))                          # 1 x 1
    return torch.mean(x, dim=(1, 2, 3)).to(torch.float32), \
        {**bn_state, "disc": ns}
