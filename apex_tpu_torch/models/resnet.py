"""ResNet (18 / 50): the imagenet example's workload.

Counterpart of ``apex_tpu/models/resnet.py``.  Parameters and batch-norm
state are nested dicts with the JAX package's tree paths, letter for letter
(``conv_init``, ``bn_init``, ``stage{s}_block{b}/{conv1..3, bn1..3,
conv_proj, bn_proj}``, ``fc_w``, ``fc_b``; batch-norm leaves ``scale`` and
``bn_bias``), so amp's ``keep_batchnorm_fp32`` finds the norms by path.
Convolution weights are stored OIHW in ``torch.channels_last``
(:func:`resnet_params_from_jax` transposes the JAX package's HWIO);
:func:`resnet_apply` takes NHWC images, as the JAX function does, and
permutes them once to a logical-NCHW tensor in channels_last memory, the
layout in which cuDNN takes its NHWC tensor-core path.

Every convolution and the max-pool pad "SAME" as XLA does, ``lo = total //
2``: at stride 2 on an even size that pads one more on the high side than
on the low, which ``F.conv2d``'s symmetric ``padding`` cannot express, so
an asymmetric pad goes through ``F.pad`` (``-inf`` for the pool).  Every
batch norm is :func:`~apex_tpu_torch.parallel.sync_batch_norm`: pass
``axis_name`` (a process group) to sync its statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from ..parallel.sync_batchnorm import sync_batch_norm
from ..utils.device import from_numpy, resolve_device

__all__ = ["ResNetConfig", "resnet50_config", "resnet18_config",
           "resnet_init", "resnet_apply", "resnet_params_from_jax",
           "same_pads"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block: str = "bottleneck"            # "basic" | "bottleneck"
    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.float32           # activation dtype (amp casts)


def resnet50_config(**kw) -> ResNetConfig:
    return ResNetConfig(**kw)


def resnet18_config(**kw) -> ResNetConfig:
    kw.setdefault("block", "basic")
    kw.setdefault("stage_sizes", (2, 2, 2, 2))
    return ResNetConfig(**kw)


def _conv_weight(hwio: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as the port stores it: OIHW, channels_last."""
    return hwio.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _bn_params(c):
    return {"scale": torch.ones(c), "bn_bias": torch.zeros(c)}


def _bn_state(c):
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def resnet_init(generator: torch.Generator, cfg: ResNetConfig, device=None):
    """(params, bn_state): He-normal convolutions, batch norm 1 / 0, the
    fc layer normal / sqrt(fan_in), drawn on the CPU from ``generator`` in
    the JAX package's order of leaves, so a seed gives the same weights on
    every device, then moved to ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    expansion = 4 if cfg.block == "bottleneck" else 1

    def conv(kh, kw, cin, cout):
        std = (2.0 / (kh * kw * cin)) ** 0.5
        return _conv_weight(std * torch.randn(kh, kw, cin, cout,
                                              generator=generator))

    params: dict = {"conv_init": conv(7, 7, 3, cfg.width),
                    "bn_init": _bn_params(cfg.width)}
    state: dict = {"bn_init": _bn_state(cfg.width)}
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * 2 ** si
        cout = cmid * expansion
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            bp: dict = {}
            bs: dict = {}
            if cfg.block == "bottleneck":
                bp["conv1"] = conv(1, 1, cin, cmid)
                bp["conv2"] = conv(3, 3, cmid, cmid)
                bp["conv3"] = conv(1, 1, cmid, cout)
                norms = (("1", cmid), ("2", cmid), ("3", cout))
            else:
                bp["conv1"] = conv(3, 3, cin, cmid)
                bp["conv2"] = conv(3, 3, cmid, cout)
                norms = (("1", cmid), ("2", cout))
            for i, c in norms:
                bp[f"bn{i}"] = _bn_params(c)
                bs[f"bn{i}"] = _bn_state(c)
            if stride != 1 or cin != cout:
                bp["conv_proj"] = conv(1, 1, cin, cout)
                bp["bn_proj"] = _bn_params(cout)
                bs["bn_proj"] = _bn_state(cout)
            params[f"stage{si}_block{bi}"] = bp
            state[f"stage{si}_block{bi}"] = bs
            cin = cout
    params["fc_w"] = torch.randn(cin, cfg.num_classes,
                                 generator=generator) * (1.0 / cin) ** 0.5
    params["fc_b"] = torch.zeros(cfg.num_classes)

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        return t.to(dev)
    return move(params), move(state)


def resnet_params_from_jax(params_np, bn_state_np, device=None):
    """The JAX package's ``(params, bn_state)`` (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's, on ``device`` (default
    ``"cuda"``): the same tree and values, each HWIO kernel as OIHW in
    channels_last."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _conv_weight(t) if t.dim() == 4 else t
    return conv(from_numpy(params_np, device)), from_numpy(bn_state_np,
                                                           device)


def same_pads(size: int, k: int, stride: int):
    """(lo, hi) of XLA's "SAME" padding along one axis: the output has
    ceil(size / stride) positions and the low side takes ``total // 2``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """"SAME" convolution of logical-NCHW ``x`` by OIHW ``w``, in x's
    dtype (the weight is cast, so its gradient flows back in its own)."""
    kh, kw = w.shape[2], w.shape[3]
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    w = w.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def _max_pool(x):
    """3 x 3 stride-2 max-pool, "SAME" with -inf padding."""
    ph = same_pads(x.shape[2], 3, 2)
    pw = same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _bn(x, p, s, *, train, axis_name, momentum=0.1, fuse_relu=False,
        z=None):
    out, new_m, new_v = sync_batch_norm(
        x, p["scale"], p["bn_bias"], s["mean"], s["var"],
        axis_name=axis_name, training=train, momentum=momentum,
        channel_last=False, fuse_relu=fuse_relu, z=z)
    return out, ({"mean": new_m, "var": new_v} if train else s)


def resnet_apply(params, bn_state, x, cfg: ResNetConfig, *, train=True,
                 axis_name=None):
    """x (N, H, W, 3) -> (logits (N, classes), new_bn_state); the logits
    and every batch norm are fp32 (float64 for float64 activations).

    ``axis_name``: the process group every batch norm syncs its statistics
    over (``None``: the default group when torch.distributed is
    initialised, else per-device statistics)."""
    x = x.to(cfg.dtype).permute(0, 3, 1, 2)      # NCHW view of NHWC memory
    x = x.contiguous(memory_format=torch.channels_last)
    new_state: dict = {}
    x = _conv(x, params["conv_init"], stride=2)
    x, new_state["bn_init"] = _bn(x, params["bn_init"], bn_state["bn_init"],
                                  train=train, axis_name=axis_name,
                                  fuse_relu=True)
    x = _max_pool(x)

    for si, n_blocks in enumerate(cfg.stage_sizes):
        for bi in range(n_blocks):
            name = f"stage{si}_block{bi}"
            bp, bs = params[name], bn_state[name]
            ns: dict = {}
            stride = 2 if (si > 0 and bi == 0) else 1
            residual = x
            if cfg.block == "bottleneck":
                y = _conv(x, bp["conv1"])
                y, ns["bn1"] = _bn(y, bp["bn1"], bs["bn1"], train=train,
                                   axis_name=axis_name, fuse_relu=True)
                y = _conv(y, bp["conv2"], stride=stride)
                y, ns["bn2"] = _bn(y, bp["bn2"], bs["bn2"], train=train,
                                   axis_name=axis_name, fuse_relu=True)
                y = _conv(y, bp["conv3"])
                last_bn = "bn3"
            else:
                y = _conv(x, bp["conv1"], stride=stride)
                y, ns["bn1"] = _bn(y, bp["bn1"], bs["bn1"], train=train,
                                   axis_name=axis_name, fuse_relu=True)
                y = _conv(y, bp["conv2"])
                last_bn = "bn2"
            if "conv_proj" in bp:
                residual = _conv(x, bp["conv_proj"], stride=stride)
                residual, ns["bn_proj"] = _bn(
                    residual, bp["bn_proj"], bs["bn_proj"], train=train,
                    axis_name=axis_name)
            # batch norm + residual add + relu in one call (groupbn's
            # batch_norm_add_relu)
            x, ns[last_bn] = _bn(y, bp[last_bn], bs[last_bn], train=train,
                                 axis_name=axis_name, fuse_relu=True,
                                 z=residual)
            new_state[name] = ns

    x = x.mean(dim=(2, 3))
    ct = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(ct) @ params["fc_w"].to(ct) + params["fc_b"].to(ct)
    return logits, new_state
