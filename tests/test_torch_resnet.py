"""ResNet of the PyTorch port against the JAX package's.

The same numpy weights (from ``apex_tpu.models.resnet_init``, converted by
``resnet_params_from_jax``) and seeded numpy images go through
``apex_tpu.models.resnet_apply`` and the port's, in fp32 on the CPU: a
basic-block ResNet-18 and a bottleneck ResNet-50 with ``conv_proj``
blocks, both at width 8 and 10 classes, on 4 x 32 x 32 x 3 images (every
stride-2 convolution and the max-pool pad asymmetrically there, one more on
the high side, as XLA's "SAME" does) and 4 x 33 x 33 x 3 (all symmetric),
in train and eval mode.  Logits agree within 5e-4, the new batch-norm
state within 1e-4 and the gradient of every leaf (``jax.grad`` against
``torch.autograd.grad``) within 2e-3, each times max(1, the reference's
largest value): fp32 sums in other orders, amplified where the last stage's
batch norm sees 4 values a channel (1 x 1 at 32 x 32).  At batch 2 that
stage sees 2 values a channel and the gradients differ by ~1e-2; the batch
is 4 for that reason.

The full ResNet-50 has the JAX tree's paths, shapes (OIHW for HWIO) and
25,557,032 parameters.  Three steps of ``resnet_train_step`` under amp O2
+ ``FusedAdam`` follow the JAX example's ``train_step``
(``examples/imagenet/main_amp.py``), step 2's images carrying an inf: the
same steps are skipped and the dynamic loss scales are the same.  With the
example's bf16 activations the losses agree within 2e-2 relative (bf16
rounding through 16 layers); with fp32 activations (fp16 weights still)
within 1e-4, the batch-norm state after step 1 within 1e-4 and the 3-step
update of the fp32 masters within 2e-3 relative in norm.  bf16 activations
leave Adam's sign-like first steps free to differ on small gradients, so
the update is held in the fp32 case only.  ``resnet_eval_step``'s top-1 and
top-5 are the JAX ``validate`` step's.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import resnet as jr
from apex_tpu.optimizers import FusedAdam as JaxAdam

from apex_tpu_torch import amp
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.train import resnet_eval_step, resnet_train_step
from apex_tpu_torch.utils.pytree import (tree_flatten, tree_leaves,
                                         tree_leaves_with_path,
                                         tree_unflatten)

BATCH = 4
LOGIT_TOL, STATE_TOL, GRAD_TOL = 5e-4, 1e-4, 2e-3
SMALL = {"resnet18": dict(block="basic", stage_sizes=(2, 2, 2, 2)),
         "resnet50": dict(stage_sizes=(1, 1, 1, 1))}


def _cfgs(arch, dtype="float32", **kw):
    base = dict(SMALL[arch], width=8, num_classes=10, **kw)
    return (jr.ResNetConfig(dtype=getattr(jnp, dtype), **base),
            tr.ResNetConfig(dtype=getattr(torch, dtype), **base))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hwio(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(2, 3, 1, 0) if t.dim() == 4 else t).numpy()


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"{what}: {err}"


def _weights(jcfg, seed=0):
    params, state = jr.resnet_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    # running statistics away from their initial 0 / 1, so eval mode reads
    # them
    state = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1
                   if float(a.reshape(-1)[0]) == 0.0
                   else np.asarray(a) + rng.uniform(0, 0.5, a.shape)
                   ).astype(np.float32), state)
    return _np(params), state


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("hw", [32, 33])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_forward_and_grads_match_jax(arch, hw, train):
    jcfg, tcfg = _cfgs(arch)
    params, state = _weights(jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, hw, hw, 3)).astype(np.float32)
    w = rng.standard_normal(10).astype(np.float32)

    def f(p):
        logits, ns = jr.resnet_apply(p, state, x, jcfg, train=train)
        return jnp.sum(logits * w), (logits, ns)
    j_grads, (j_logits, j_state) = jax.jit(jax.grad(f, has_aux=True))(
        params)

    tp, ts = tr.resnet_params_from_jax(params, state, device="cpu")
    leaves, treedef = tree_flatten(tp)
    leaves = [l.requires_grad_(True) for l in leaves]
    logits, new_state = tr.resnet_apply(tree_unflatten(treedef, leaves), ts,
                                        torch.from_numpy(x), tcfg,
                                        train=train)
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                                leaves)

    _close(logits.detach().numpy(), j_logits, LOGIT_TOL, "logits")
    j_paths = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_flatten_with_path(j_state)[0]]
    assert len(j_paths) == len(tree_leaves(new_state))
    for path, a, b in zip(j_paths, jax.tree_util.tree_leaves(j_state),
                          tree_leaves(new_state)):
        _close(b.numpy(), a, STATE_TOL, f"state {path}")
    for (path, _), a, b in zip(
            jax.tree_util.tree_flatten_with_path(j_grads)[0],
            jax.tree_util.tree_leaves(j_grads), grads):
        _close(_hwio(b), a, GRAD_TOL, f"grad {jax.tree_util.keystr(path)}")


def test_same_pads_is_xla_same():
    for size, k, s in [(224, 7, 2), (112, 3, 2), (56, 3, 2), (33, 7, 2),
                       (17, 3, 2), (56, 1, 2), (28, 3, 1), (7, 3, 1)]:
        lo, hi = tr.same_pads(size, k, s)
        assert jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME") == \
            [(lo, hi)], (size, k, s)


def test_resnet50_tree_matches_jax():
    jcfg, tcfg = jr.resnet50_config(), tr.resnet50_config()
    j_params, j_state = jax.eval_shape(
        lambda: jr.resnet_init(jax.random.PRNGKey(0), jcfg))
    params, state = tr.resnet_init(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu")

    def shapes(tree):
        return {"/".join(str(k) for k in p): tuple(l.shape)
                for p, l in tree_leaves_with_path(tree)}

    def j_shapes(tree):
        return {"/".join(k.key for k in p): tuple(l.shape) for p, l in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    hwio = {k: (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
            for k, s in shapes(params).items()}
    assert hwio == j_shapes(j_params)
    assert shapes(state) == j_shapes(j_state)
    n = sum(int(np.prod(s)) for s in hwio.values())
    assert n == sum(int(np.prod(s)) for s in j_shapes(j_params).values()) \
        == 25_557_032
    assert params["conv_init"].is_contiguous(
        memory_format=torch.channels_last)
    again, _ = tr.resnet_init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    assert torch.equal(again["stage3_block2"]["conv3"],
                       params["stage3_block2"]["conv3"])


def _jax_steps(params, state, batches, jcfg, scale):
    st = jamp.initialize(params, JaxAdam(lr=1e-3), opt_level="O2",
                         verbosity=0)
    st = st._replace(scalers=tuple(s._replace(loss_scale=jnp.float32(scale))
                                   for s in st.scalers))

    @jax.jit
    def train_step(state, bn_state, images, labels):    # main_amp.py's
        def loss_fn(p):
            logits, new_bn = jr.resnet_apply(p, bn_state, images, jcfg,
                                             train=True)
            lp = jax.nn.log_softmax(logits.astype(jnp.float32))
            loss = -jnp.mean(jnp.take_along_axis(lp, labels[:, None],
                                                 axis=1))
            return jamp.scale_loss(loss, state), (new_bn, loss)
        grads, (new_bn, loss) = jax.grad(loss_fn, has_aux=True)(
            state.model_params)
        return jamp.amp_step(state, grads), new_bn, loss

    losses, scales, bns = [], [], []
    for x, y in batches:
        st, state, loss = train_step(st, state, x, y)
        losses.append(float(loss))
        scales.append(float(st.loss_scale))
        bns.append(_np(state))
    return losses, scales, bns, st


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_o2_steps_match_jax_example(act):
    """amp O2 (fp16 weights, fp32 batch norm) + FusedAdam(lr=1e-3), with
    the dynamic scaler started at 2^12 in both packages, so that the clean
    steps' largest scaled fp16 gradient (~6 x 4096) sits well below fp16's
    largest value and the skip pattern comes from step 2's inf alone."""
    jcfg, tcfg = _cfgs("resnet50", act)
    params, state = _np(jr.resnet_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    batches = []
    for i in range(3):
        x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
        if i == 1:
            x[0, 3, 5, 1] = np.inf
        batches.append((x, rng.integers(0, 10, (8,)).astype(np.int32)))
    j_losses, j_scales, j_bns, j_st = _jax_steps(params, state, batches,
                                                 jcfg, 4096.0)

    tp, bn = tr.resnet_params_from_jax(params, state, device="cpu")
    st = amp.initialize(tp, FusedAdam(lr=1e-3), opt_level="O2", verbosity=0)
    st = st._replace(scalers=tuple(s._replace(loss_scale=torch.tensor(4096.))
                                   for s in st.scalers))
    assert st.model_params["conv_init"].dtype == torch.float16
    assert st.model_params["bn_init"]["scale"].dtype == torch.float32
    losses, scales, bns = [], [], []
    for x, y in batches:
        st, bn, loss, _ = resnet_train_step(st, bn, torch.from_numpy(x),
                                            torch.from_numpy(y), tcfg)
        losses.append(float(loss))
        scales.append(float(st.loss_scale))
        bns.append([t.numpy() for t in tree_leaves(bn)])

    assert scales == j_scales == [4096.0, 2048.0, 2048.0]
    assert not np.isfinite(losses[1]) and not np.isfinite(j_losses[1])
    tol = 1e-4 if act == "float32" else 2e-2
    for i in (0, 2):
        assert abs(losses[i] - j_losses[i]) <= tol * abs(j_losses[i]), \
            (losses, j_losses)
    assert st.model_params["conv_init"].dtype == torch.float16
    if act == "float32":
        for a, b in zip(jax.tree_util.tree_leaves(j_bns[0]), bns[0]):
            _close(b, a, STATE_TOL, "bn state after step 1")
        j_m = jax.tree_util.tree_leaves(j_st.master_params)
        num = den = 0.0
        for a, b, p0 in zip(j_m, tree_leaves(st.master_params),
                            jax.tree_util.tree_leaves(params)):
            num += float(((np.asarray(a) - _hwio(b)) ** 2).sum())
            den += float(((np.asarray(a) - p0) ** 2).sum())
        assert np.sqrt(num / den) <= 2e-3, np.sqrt(num / den)


def test_eval_step_matches_jax_validate():
    jcfg, tcfg = _cfgs("resnet18")
    params, state = _weights(jcfg, seed=4)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (16,)).astype(np.int32)
    logits, _ = jr.resnet_apply(params, state, x, jcfg, train=False)
    j_top1 = float(jnp.mean(jnp.argmax(logits, axis=1) == y))
    j_top5 = float(jnp.mean(jnp.any(jax.lax.top_k(logits, 5)[1]
                                    == y[:, None], axis=1)))
    tp, ts = tr.resnet_params_from_jax(params, state, device="cpu")
    st = amp.initialize(tp, None, opt_level="O0", verbosity=0)
    top1, top5 = resnet_eval_step(st, ts, torch.from_numpy(x),
                                  torch.from_numpy(y), tcfg)
    assert (float(top1), float(top5)) == (j_top1, j_top5)
    assert 0.0 < j_top5 < 1.0
