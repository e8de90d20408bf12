"""Driver: the imagenet example's training step, ResNet-50 through
``apex_tpu_torch.train.resnet_train_step`` under amp O2 and FusedAdam.

Set-up makes the weights on the card from the seed and drives the amp
state through its first steps with the window's own call, each on its own
batch, until three steps have updated the weights (a step whose fp16
gradients overflow is skipped and halves the loss scale, as O2's dynamic
scale does; at most ``max_first_steps``).  These steps are the warm-up
too, cuDNN's autotuning among them.  Each batch is made on the card from
(seed, step): class prototypes plus N(0, 0.08^2) noise, after the
example's ``synthetic_batches`` (examples/imagenet/main_amp.py:129-167),
over all 1000 classes.  After the window the float32 reference replays
the first steps: the same weights, batches and batch-norm statistics,
Adam, and the loss scale's skips worked out from its own gradients."""
from __future__ import annotations

import gc
import math
from typing import List

import torch

from perfbench.lib import compare, frozen
from perfbench.reference import lowp, optim as ref_optim
from perfbench.reference import resnet as ref
from perfbench.reference.tree import leaves, paths

FIRST_APPLIED = 3
#: the largest finite fp16 value rounds up to inf from here
FP16_OVERFLOW = 65520.0


def _convs(c: dict):
    """(path, (O, I, kh, kw)) of every convolution, in the model's order."""
    w, out = c["width_per_group"], []
    out.append(("conv_init", (w, 3, 7, 7)))
    cin = w
    for si, n in enumerate(c["layers"]):
        cmid = w * 2 ** si
        cout = cmid * 4
        for bi in range(n):
            name = f"stage{si}_block{bi}"
            out += [(f"{name}.conv1", (cmid, cin, 1, 1)),
                    (f"{name}.conv2", (cmid, cmid, 3, 3)),
                    (f"{name}.conv3", (cout, cmid, 1, 1))]
            if (si > 0 and bi == 0) or cin != cout:
                out.append((f"{name}.conv_proj", (cout, cin, 1, 1)))
            cin = cout
    return out, cin


def _norms(c: dict):
    """(path, channels) of every batch norm."""
    w, out = c["width_per_group"], [("bn_init", c["width_per_group"])]
    cin = w
    for si, n in enumerate(c["layers"]):
        cmid = w * 2 ** si
        cout = cmid * 4
        for bi in range(n):
            name = f"stage{si}_block{bi}"
            out += [(f"{name}.bn1", cmid), (f"{name}.bn2", cmid),
                    (f"{name}.bn3", cout)]
            if (si > 0 and bi == 0) or cin != cout:
                out.append((f"{name}.bn_proj", cout))
            cin = cout
    return out


def _put(tree, path, value):
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def make_params(c: dict, seed: int, device):
    """(float32 params, batch-norm statistics) from ``seed``, in the
    port's tree: He-normal convolutions (OIHW, channels-last memory) and
    the fc layer normal / sqrt(fan_in) from one normal draw, batch norm
    1 / 0, statistics 0 / 1."""
    convs, cin = _convs(c)
    classes = c["num_classes"]
    sizes = [math.prod(s) for _, s in convs] + [cin * classes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    params: dict = {}
    off = 0
    for (path, s), n in zip(convs, sizes):
        std = (2.0 / (s[1] * s[2] * s[3])) ** 0.5
        _put(params, path, (flat[off:off + n].view(s) * std).contiguous(
            memory_format=torch.channels_last))
        off += n
    params["fc_w"] = flat[off:off + cin * classes].view(cin, classes) \
        * (1.0 / cin) ** 0.5
    params["fc_b"] = torch.zeros(classes, device=device)
    stats: dict = {}
    for path, ch in _norms(c):
        _put(params, path, {"scale": torch.ones(ch, device=device),
                            "bn_bias": torch.zeros(ch, device=device)})
        _put(stats, path, {"mean": torch.zeros(ch, device=device),
                           "var": torch.ones(ch, device=device)})
    return params, stats


def make_protos(c: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    hw = c["image_size"]
    return torch.rand(c["num_classes"], hw, hw, 3, generator=gen,
                      device=device)


def make_batch(protos, t: dict, seed: int, step: int, device):
    """Batch ``step`` of the run of ``seed``: NHWC float32 images and
    int64 labels."""
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)
    labels = torch.randint(0, protos.shape[0], (t["batch"],),
                           generator=gen, device=device)
    noise = torch.randn((t["batch"],) + tuple(protos.shape[1:]),
                        generator=gen, device=device)
    return protos[labels] + t["noise"] * noise, labels


def _fp16_leaf(path: str) -> bool:
    """O2 keeps the batch norms' parameters in float32, the rest in
    float16."""
    return ".bn" not in f".{path}"


class Run:
    """One cell's program, driven from ``seed``."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        from apex_tpu_torch import amp, train
        from apex_tpu_torch.models.resnet import ResNetConfig
        from apex_tpu_torch.optimizers import FusedAdam
        self.c, self.w, self.seed, self.device = config, workload, seed, device
        t = workload["mix"]
        self.train = train
        self.cfg = ResNetConfig(block="bottleneck",
                                stage_sizes=tuple(config["layers"]),
                                num_classes=config["num_classes"],
                                width=config["width_per_group"],
                                dtype=getattr(torch,
                                              workload["activation_dtype"]))
        params, self.bn = make_params(config, seed, device)
        o = workload["optimizer"]
        self.state = amp.initialize(
            params, FusedAdam(lr=o["lr"], betas=tuple(o["betas"]),
                              eps=o["eps"], impl=o["impl"]),
            opt_level=workload["opt_level"], verbosity=0)
        del params
        self.protos = make_protos(config, seed + 1, device)
        self.losses: List[torch.Tensor] = []
        self.scales: List[torch.Tensor] = []
        self.i = 0
        b1 = o["betas"][0]
        self.applied: List[bool] = []
        self.grad1 = None
        while sum(self.applied) < FIRST_APPLIED \
                and len(self.applied) < t["max_first_steps"]:
            count = int(self.state.opt_state.count)
            self.step()
            self.applied.append(int(self.state.opt_state.count) > count)
            if self.applied[-1] and self.grad1 is None:
                self.grad1 = [n / (1.0 - b1) for n in compare.leaf_norms(
                    leaves(self.state.opt_state.m))]
        init, stats0 = make_params(config, seed, device)
        self.master_change = compare.leaf_norms(
            leaves(self.state.master_params), leaves(init))
        self.bn_change = compare.leaf_norms(leaves(self.bn), leaves(stats0))
        del init, stats0
        self.first_losses = [float(x) for x in self.losses]
        self.first_scales = [float(x) for x in self.scales]
        self.losses, self.scales = [], []

    # -- the window ---------------------------------------------------------

    @property
    def items_per_step(self) -> int:
        return self.w["mix"]["batch"]

    item_unit = "images"

    @property
    def flops_per_step(self) -> float:
        c = self.c
        return 3.0 * frozen.resnet_flops(
            c["layers"], c["width_per_group"], c["num_classes"],
            c["image_size"]) * self.w["mix"]["batch"]

    kernel_shapes: dict = {}

    def step(self) -> None:
        images, labels = make_batch(self.protos, self.w["mix"], self.seed,
                                    self.i, self.device)
        self.i += 1
        self.scales.append(self.state.loss_scale)
        self.state, self.bn, loss, _ = self.train.resnet_train_step(
            self.state, self.bn, images, labels, self.cfg)
        self.losses.append(loss)

    def finish(self) -> dict:
        """Read the window's losses and scales, then free the program's
        state."""
        losses = torch.stack(self.losses).float().cpu() if self.losses \
            else torch.zeros(0)
        scales = [float(s) for s in self.scales] \
            + [float(self.state.loss_scale)]
        skipped = sum(b < a for a, b in zip(scales, scales[1:]))
        failed = int((~torch.isfinite(losses)).sum())
        del self.state, self.bn, self.protos, self.losses, self.scales
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return {"failed": failed, "notes": [
            f"overflow-skipped steps: {skipped} of {len(losses)} in the "
            f"window; {self.applied.count(False)} of the "
            f"{len(self.applied)} first steps"]}

    # -- the comparison -------------------------------------------------------

    def program_readings(self) -> dict:
        return {"losses": self.first_losses, "applied": self.applied,
                "grad1": self.grad1, "master_change": self.master_change,
                "bn_change": self.bn_change}

    def reference_readings(self) -> dict:
        return reference_readings(self.c, self.w, self.seed, self.device,
                                  self.applied)

    def control_readings(self) -> dict:
        return control_readings(self.c, self.w, self.seed, self.device,
                                self.applied)

    def compare(self) -> List[dict]:
        return compare.judge(gaps(self.program_readings(),
                                  self.reference_readings()),
                             self.w["limits"])


def reference_readings(c: dict, w: dict, seed: int, device,
                       program_applied: List[bool],
                       conv_fn=ref.conv, act=ref.identity) -> dict:
    """The float32 reference's replay of the first steps.  A step is
    skipped where its gradient times the loss scale would overflow fp16 in
    a float16 leaf.  The program's bf16 gradients reach their largest
    element with an error of some percent, so within ``overflow_band``
    (as multiples of the threshold) the program's decision stands
    (``ambiguous`` marks those steps); outside it the reference decides."""
    t, o = w["mix"], w["optimizer"]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        params, stats = make_params(c, seed, device)
        stats0 = [s.clone() for s in leaves(stats)]
        protos = make_protos(c, seed + 1, device)
        ps = leaves(params)
        half = [_fp16_leaf(p) for p in paths(params)]
        init = [p.clone() for p in ps]
        opt = ref_optim.Adam(o["lr"], betas=tuple(o["betas"]), eps=o["eps"])
        scale = float(t["init_loss_scale"])
        losses, applied, ambiguous, grad1 = [], [], [], None
        for i, prog in enumerate(program_applied):
            images, labels = make_batch(protos, t, seed, i, device)
            loss, grads, stats = ref.loss_and_grads(
                params, stats, images, labels, leaves, c["layers"], conv_fn,
                act)
            losses.append(float(loss))
            peak = max(float(g.abs().max()) for g, h in zip(grads, half)
                       if h) * scale / FP16_OVERFLOW
            lo, hi = t["overflow_band"]
            ambiguous.append(lo <= peak <= hi)
            ok = prog if ambiguous[-1] else peak < 1.0
            applied.append(ok)
            if ok:
                with torch.no_grad():
                    opt.step(ps, grads)
                if grad1 is None:
                    grad1 = [float(m.norm()) / (1.0 - opt.b1) for m in opt.m]
            else:
                scale /= 2.0
            del grads
        return {"losses": losses, "grad1": grad1, "applied": applied,
                "ambiguous": ambiguous,
                "change": compare.leaf_norms(ps, init),
                "bn_change": compare.leaf_norms(leaves(stats), stats0)}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def gaps(got: dict, want: dict) -> dict:
    """Every number the calibration reads; the cell's ``limits`` name the
    ones compared.  ``skip_mismatch``: skip decisions that disagree with
    the reference's own outside its band; ``loss1``: the first step's
    loss (both sides at the seed's weights); ``loss``: the worst of the
    first steps'; ``grad1`` / ``grad1_median``: the worst / the median
    leaf's first gradient; ``master_change`` / ``master_median``: the
    worst / the median moved leaf's change of the fp32 masters;
    ``bn_change`` / ``bn_median``: the worst / the median leaf's change of
    the batch-norm statistics."""
    n = len(want["applied"])
    mismatch = len(got["applied"]) != n
    mismatch += sum(1 for i, a in enumerate(got["applied"][:n])
                    if not want["ambiguous"][i] and a != want["applied"][i])
    out = {"skip_mismatch": float(mismatch)}
    names = ("loss1", "loss", "grad1", "grad1_median", "master_change",
             "master_median", "bn_change", "bn_median")
    if got["grad1"] is None or want["grad1"] is None:
        # no step updated the weights: nothing to compare them by
        return dict(out, **{k: math.inf for k in names})
    include = compare.moved(want["grad1"])
    moved_got = [c for c, i in zip(got["master_change"], include) if i]
    moved_want = [c for c, i in zip(want["change"], include) if i]
    out.update(
        loss1=compare.rel_gap(got["losses"][0], want["losses"][0]),
        loss=max(compare.rel_gap(a, b)
                 for a, b in zip(got["losses"], want["losses"])),
        grad1=compare.worst_leaf_gap(got["grad1"], want["grad1"]),
        grad1_median=compare.median_leaf_gap(got["grad1"], want["grad1"]),
        master_change=compare.worst_leaf_gap(
            got["master_change"], want["change"], include),
        master_median=compare.median_leaf_gap(moved_got, moved_want),
        bn_change=compare.worst_leaf_gap(got["bn_change"],
                                         want["bn_change"]),
        bn_median=compare.median_leaf_gap(got["bn_change"],
                                          want["bn_change"]))
    return out


def control_readings(c: dict, w: dict, seed: int, device,
                     program_applied: List[bool]) -> dict:
    """The control: the reference with its convolutions' operands in
    float8, in the program's place (its own skips, at its own
    threshold)."""
    r = reference_readings(c, w, seed, device, program_applied,
                           conv_fn=lowp.conv, act=lowp.round_fp8)
    return {"losses": r["losses"], "applied": r["applied"],
            "grad1": r["grad1"], "master_change": r["change"],
            "bn_change": r["bn_change"]}
