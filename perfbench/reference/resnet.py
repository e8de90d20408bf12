"""ResNet-50 (v1.5: the stride on the 3x3 convolution) in plain float32
PyTorch, as ``configs/resnet50.json`` states it: "SAME" padding as XLA
pads (the low side takes ``total // 2``), batch norm on the batch's
statistics with the running statistics updated at momentum 0.1 (the
running variance unbiased), the block's last norm adding the residual
before its ReLU, a global mean pool and a float32 fc layer.

Parameters: ``conv_init`` (O, I, H, W), ``bn_init`` {scale, bn_bias},
``stage{s}_block{b}`` {conv1, conv2, conv3, bn1, bn2, bn3[, conv_proj,
bn_proj]}, ``fc_w`` (C, classes), ``fc_b``; statistics: the same norms'
{mean, var}."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.1


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int = 1):
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = _same(x.shape[2], kh, stride), _same(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def identity(x):
    return x


def _bn(x, p, s, new_stats, name, relu=True, z=None):
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    with torch.no_grad():
        new_stats[name] = {
            "mean": (1 - MOMENTUM) * s["mean"] + MOMENTUM * mean,
            "var": (1 - MOMENTUM) * s["var"] + MOMENTUM * var * n / (n - 1)}
    y = (x - mean[None, :, None, None]) * torch.rsqrt(
        var[None, :, None, None] + EPS)
    y = y * p["scale"][None, :, None, None] + p["bn_bias"][None, :, None, None]
    if z is not None:
        y = y + z
    return torch.relu(y) if relu else y


def forward(params, stats, images, stage_sizes=(3, 4, 6, 3),
            conv_fn: Callable = conv, act: Callable = identity):
    """images (N, H, W, 3) -> (logits (N, classes), new statistics).
    ``conv_fn`` computes every convolution and ``act`` rounds every
    activation the model keeps between operations (the identity here; the
    control's lower precision)."""
    def cv(x, w, stride=1):
        return act(conv_fn(x, w, stride))

    def bn(x, p, s, ns, name, relu=True, z=None):
        return act(_bn(x, p, s, ns, name, relu, z))

    x = act(images.permute(0, 3, 1, 2))
    new: dict = {}
    x = cv(x, params["conv_init"], 2)
    x = bn(x, params["bn_init"], stats["bn_init"], new, "bn_init")
    ph, pw = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                           value=float("-inf")), 3, 2)
    for si, n_blocks in enumerate(stage_sizes):
        for bi in range(n_blocks):
            name = f"stage{si}_block{bi}"
            bp, bs = params[name], stats[name]
            ns: dict = {}
            stride = 2 if (si > 0 and bi == 0) else 1
            y = bn(cv(x, bp["conv1"]), bp["bn1"], bs["bn1"], ns, "bn1")
            y = bn(cv(y, bp["conv2"], stride), bp["bn2"], bs["bn2"], ns,
                   "bn2")
            y = cv(y, bp["conv3"])
            res = x
            if "conv_proj" in bp:
                res = bn(cv(x, bp["conv_proj"], stride), bp["bn_proj"],
                         bs["bn_proj"], ns, "bn_proj", relu=False)
            x = bn(y, bp["bn3"], bs["bn3"], ns, "bn3", z=res)
            new[name] = ns
    logits = x.mean(dim=(2, 3)) @ params["fc_w"] + params["fc_b"]
    return logits, new


def loss_and_grads(params, stats, images, labels, leaves_of,
                   stage_sizes=(3, 4, 6, 3), conv_fn: Callable = conv,
                   act: Callable = identity):
    """(loss, grads in ``leaves_of(params)`` order, new statistics): the
    mean negative log-likelihood of ``labels`` over the batch."""
    ps = leaves_of(params)
    for p in ps:
        p.requires_grad_(True)
    logits, new = forward(params, stats, images, stage_sizes, conv_fn, act)
    loss = -torch.log_softmax(logits, -1).gather(
        1, labels.long()[:, None]).mean()
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    return loss.detach(), list(grads), new
