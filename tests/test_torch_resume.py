"""The imagenet example's ``--save`` / ``--resume`` / ``--data`` path in the
port, against the JAX package's.

A narrow ResNet-18 (width 8, 10 classes, 32 x 32 images) under amp O2 +
``FusedAdam(lr=1e-3)``, the dynamic scaler started at 2^12 in both
packages as ``tests/test_torch_resnet.py`` does:

- the JAX example's state after 2 steps, saved by ``apex_tpu.checkpoint``
  with the example's entries, is resumed in the port
  (``resnet_checkpoint_from_jax`` -> ``resnet_resume`` into a state built
  from another seed); the port's next 2 steps follow the JAX package's
  next 2 within ``tests/test_torch_resnet.py``'s tolerances for this
  comparison: with fp32 activations losses 1e-4 relative, the batch-norm
  statistics after the first resumed step 1e-4, the 2-step update of the
  fp32 masters 2e-3 relative in norm; with the example's bf16 activations
  losses 2e-2 relative;
- inside the port, 2 steps + ``CheckpointManager`` save + load into a
  fresh state + ``ShardedLoader.seek`` + 2 steps give the bits of 4
  straight steps: fp16 weights, fp32 masters, Adam's m / v / count, the
  running statistics, the scaler and the 4 losses;
- ``resnet_sharded_batches`` gives the JAX example's
  ``sharded_npz_loader`` batches bit for bit (uint8 -> fp32 / 255, int32
  labels), and ``resnet_checkpoint_entries`` the example's entries.
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import checkpoint as jckpt
from apex_tpu.models import resnet as jr
from apex_tpu.optimizers import FusedAdam as JaxAdam

from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import CheckpointManager
from apex_tpu_torch.resilience.ckpt import META_DATA_KEY
from apex_tpu_torch.train import (resnet_checkpoint_entries,
                                  resnet_checkpoint_from_jax, resnet_resume,
                                  resnet_sharded_batches, resnet_train_step)
from apex_tpu_torch.utils.pytree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 4096.0
HW, BATCH, CLASSES = 32, 8, 10


def _cfgs(act):
    base = dict(block="basic", stage_sizes=(2, 2, 2, 2), width=8,
                num_classes=CLASSES)
    return (jr.ResNetConfig(dtype=getattr(jnp, act), **base),
            tr.ResNetConfig(dtype=getattr(torch, act), **base))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hwio(t):
    t = t.detach().float()
    return (t.permute(2, 3, 1, 0) if t.dim() == 4 else t).numpy()


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, HW, HW, 3)).astype(np.float32),
             rng.integers(0, CLASSES, (BATCH,)).astype(np.int32))
            for _ in range(n)]


def _example():
    """The JAX imagenet example as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "imagenet_main_amp", os.path.join(REPO, "examples", "imagenet",
                                          "main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_state(tcfg, seed):
    params, bn = tr.resnet_init(torch.Generator().manual_seed(seed), tcfg,
                                device="cpu")
    st = amp.initialize(params, FusedAdam(lr=1e-3), opt_level="O2",
                        verbosity=0)
    st = st._replace(scalers=tuple(s._replace(loss_scale=torch.tensor(SCALE))
                                   for s in st.scalers))
    return st, bn


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_jax_saved_state_resumes_in_port(act, tmp_path):
    jcfg, tcfg = _cfgs(act)
    params, state = _np(jr.resnet_init(jax.random.PRNGKey(0), jcfg))
    st = jamp.initialize(params, JaxAdam(lr=1e-3), opt_level="O2",
                         verbosity=0)
    st = st._replace(scalers=tuple(s._replace(loss_scale=jnp.float32(SCALE))
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

    batches = _batches(4)
    bn = state
    for x, y in batches[:2]:
        st, bn, _ = train_step(st, bn, x, y)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save(path, step=2, model=st.model_params,           # main_amp.py
               masters=st.master_params, opt=st.opt_state,    # :450-452
               amp=jamp.state_dict(st), bn=bn)
    saved_masters = _np(st.master_params)
    j_losses, j_bns = [], []
    for x, y in batches[2:]:
        st, bn, loss = train_step(st, bn, x, y)
        j_losses.append(float(loss))
        j_bns.append(_np(bn))

    pst, pbn = _port_state(tcfg, seed=5)
    payload = resnet_checkpoint_from_jax(checkpoint.load(path))
    pst, pbn, start = resnet_resume(payload, pst, pbn)
    assert start == 2
    assert pst.model_params["stage0_block0"]["conv1"].dtype == torch.float16
    assert pst.model_params["conv_init"].is_contiguous(
        memory_format=torch.channels_last)
    losses, bns = [], []
    for x, y in batches[2:]:
        pst, pbn, loss, _ = resnet_train_step(
            pst, pbn, torch.from_numpy(x), torch.from_numpy(y), tcfg)
        losses.append(float(loss))
        bns.append([t.numpy() for t in tree_leaves(pbn)])
    assert float(pst.loss_scale) == float(st.loss_scale)
    tol = 1e-4 if act == "float32" else 2e-2
    for a, b in zip(losses, j_losses):
        assert abs(a - b) <= tol * abs(b), (losses, j_losses)
    if act == "float32":
        for a, b in zip(jax.tree_util.tree_leaves(j_bns[0]), bns[0]):
            err = np.abs(b - a).max()
            assert err <= 1e-4 * max(1.0, np.abs(a).max()), err
        num = den = 0.0
        for a, b, p0 in zip(jax.tree_util.tree_leaves(st.master_params),
                            tree_leaves(pst.master_params),
                            jax.tree_util.tree_leaves(saved_masters)):
            num += float(((np.asarray(a) - _hwio(b)) ** 2).sum())
            den += float(((np.asarray(a) - p0) ** 2).sum())
        assert np.sqrt(num / den) <= 2e-3, np.sqrt(num / den)


def _write_image_shards(d, n=64, shards=4, seed=0):
    rng = np.random.default_rng(seed)
    per = n // shards
    for i in range(shards):
        np.savez(os.path.join(d, f"shard-{i:03d}.npz"),
                 images=rng.integers(0, 256, (per, HW, HW, 3), dtype=np.uint8),
                 labels=rng.integers(0, CLASSES, per).astype(np.int64))


def _state_bits(st, bn):
    leaves = (tree_leaves(st.model_params) + tree_leaves(st.master_params)
              + tree_leaves(st.opt_state) + tree_leaves(bn))
    return [(t.dtype, t.numpy().tobytes()) for t in leaves] + [
        amp.state_dict(st)]


def test_resume_inside_port_is_bitwise(tmp_path):
    """2 steps, a manager save with the loader's data meta and cursor,
    a fresh state from another seed, ``load_latest`` -> ``resnet_resume``
    -> ``seek`` -> 2 steps: the bits of 4 straight steps."""
    _, tcfg = _cfgs("bfloat16")
    d = str(tmp_path / "data")
    os.makedirs(d)
    _write_image_shards(d)

    st, bn = _port_state(tcfg, seed=0)
    straight = []
    for x, y in resnet_sharded_batches(d, BATCH, 7, 4, device="cpu"):
        st, bn, loss, _ = resnet_train_step(st, bn, x, y, tcfg)
        straight.append(float(loss))
    want = _state_bits(st, bn)

    loader = resnet_sharded_batches(d, BATCH, 7, 4, device="cpu")
    st, bn = _port_state(tcfg, seed=0)
    resumed = []
    for step, (x, y) in enumerate(loader):
        st, bn, loss, _ = resnet_train_step(st, bn, x, y, tcfg)
        resumed.append(float(loss))
        if step == 1:
            break
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last=2)
    mgr.set_meta({META_DATA_KEY: dict(loader.data_meta(),
                                      cursor=loader.cursor(2))})
    mgr.save(2, resnet_checkpoint_entries(st, bn, 2))

    st, bn = _port_state(tcfg, seed=9)
    step, payload, meta = mgr.load_latest(with_meta=True)
    assert step == 2
    assert meta[META_DATA_KEY]["index_digest"] == loader.index_digest
    st, bn, start = resnet_resume(payload, st, bn)
    loader = resnet_sharded_batches(d, BATCH, 7, 4, device="cpu")
    assert loader.cursor(start) == meta[META_DATA_KEY]["cursor"]
    loader.seek(start)
    for x, y in loader:
        st, bn, loss, _ = resnet_train_step(st, bn, x, y, tcfg)
        resumed.append(float(loss))
    assert resumed == straight
    got = _state_bits(st, bn)
    assert len(got) == len(want)
    assert all(a == b for a, b in zip(got, want))


def test_entries_and_batches_match_the_jax_example(tmp_path, monkeypatch):
    ex = _example()
    d = str(tmp_path)
    _write_image_shards(d, n=48, shards=3, seed=2)
    args = types.SimpleNamespace(data=d, seed=4)
    jl = ex.sharded_npz_loader(args, 8, 6)
    pl = resnet_sharded_batches(d, 8, 4, 6, device="cpu")
    for s in range(6):
        (jx, jy), (px, py) = jl(s), pl(s)
        assert px.dtype == torch.float32 and py.dtype == torch.int32
        assert px.numpy().tobytes() == np.asarray(jx).tobytes()
        assert py.numpy().tobytes() == np.asarray(jy).tobytes()
    _, tcfg = _cfgs("float32")
    st, bn = _port_state(tcfg, seed=0)
    e = resnet_checkpoint_entries(st, bn, 3)
    assert sorted(e) == ["amp", "bn", "masters", "model", "opt", "step"]
    assert e["step"] == 3 and e["amp"] == amp.state_dict(st)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet_sharded_batches(d, 8, 4, 6)          # the default device
