"""The training slice of the PyTorch port against the JAX package.

One JAX parameter tree goes to both packages (``params_from_jax``); the
same numpy batches go through three steps of each package's training step
(``transformer_loss`` -> ``scale_loss`` -> gradients -> ``amp_step``) under
amp O5 with FusedLAMB on the flat engine (``impl="fused"``).  With the
``cast_model_type=float32`` override (the fp32 oracle of the O5 flow) the
losses agree to 1e-5 relative and the flat masters to 1e-5, for flash and
plain attention, with and without remat.  At O5 proper (bf16 model) the
losses agree to 2e-2: the two frameworks round bf16 at other places.
Dropout is 0: the port's per-layer seeds are not the JAX key splits.

The ZeRO step (``zero_train_step`` with ``DistributedFusedLAMB``, fp32
params and activations, flash attention and remat) goes against a JAX
step written as the BERT example's ``run_zero`` writes it (``shard_map``
over the data axis, ``value_and_grad``, ``opt.step``, ``pmean`` of the
loss): at world 1 in this process, at world 2 as two spawned gloo ranks
(``tests/_torch_dist.py``) each taking its half of the batch, and at world
1 with every flash backward forced onto the split route (the JAX package
through ``APEX_TPU_FLASH_BWD_FUSE=0``).  Losses and master shards agree to
1e-5.

The fp16 MLP step (``mlp_train_step``: ``MLP([16, 32, 8])`` in fp16 under
``FP16_Optimizer(FusedAdam(impl="fused"), dynamic_loss_scale=True)``)
goes against the same composition in the JAX package (``MLP.apply`` with
``use_pallas=True``, the MSE loss, ``jax.value_and_grad`` of the scaled
loss, ``FP16_Optimizer.step``) for 3 steps whose second batch carries an
inf: the same overflow pattern and loss scales, losses within 1e-3
relative (fp16 activations rounded from fp32 sums in other orders), the
flat fp32 masters within 1e-5 and the fp16 params within one fp16 step.
"""
import functools
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist
from apex_tpu import amp as jamp
from apex_tpu.contrib.optimizers import FP16_Optimizer as JaxFP16
from apex_tpu.contrib.optimizers import DistributedFusedLAMB as JaxZeroLAMB
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.models import transformer_loss as jax_loss
from apex_tpu.mlp import MLP as JaxMLP
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu.parallel.mesh import shard_map

from apex_tpu_torch import amp
from apex_tpu_torch.models import (TransformerConfig, params_from_jax,
                                   transformer_loss)
from apex_tpu_torch.contrib.optimizers import FP16_Optimizer
from apex_tpu_torch.mlp import MLP, mlp_params_from_jax
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.train import mlp_train_step, train_step
from apex_tpu_torch.utils.pytree import tree_leaves

DIMS = dict(vocab_size=211, max_len=64, num_layers=2, d_model=64,
            num_heads=4, d_ff=128)
B, S, STEPS = 2, 48, 3


def _batches():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, DIMS["vocab_size"], (B, S)).astype(np.int32)
        targets = rng.integers(0, DIMS["vocab_size"], (B, S)).astype(np.int32)
        weights = (rng.random((B, S)) > 0.2).astype(np.float32)
        out.append(dict(tokens=tokens, targets=targets, weights=weights))
    return out


def _run_jax(tree, cfg_kw, batches, cast):
    cfg = JaxConfig(**DIMS, **cfg_kw)
    st = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, tree),
                         JaxLAMB(lr=1e-2, weight_decay=0.01,
                                 max_grad_norm=1.0, impl="fused"),
                         opt_level="O5", cast_model_type=cast, verbosity=0)

    @jax.jit
    def step(st, batch):
        def loss_fn(p):
            return jamp.scale_loss(jax_loss(p, batch, cfg), st)
        loss, grads = jax.value_and_grad(loss_fn)(st.model_params)
        return jamp.amp_step(st, grads), loss

    losses = []
    for b in batches:
        st, loss = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return losses, np.asarray(st.opt_state.master)


def _run_port(tree, cfg_kw, batches, cast):
    cfg = TransformerConfig(**DIMS, **cfg_kw)
    st = amp.initialize(params_from_jax(tree, device="cpu"),
                        FusedLAMB(lr=1e-2, weight_decay=0.01,
                                  max_grad_norm=1.0, impl="fused"),
                        opt_level="O5", cast_model_type=cast, verbosity=0)
    losses = []
    for b in batches:
        st, loss = train_step(st, {k: torch.from_numpy(v).long()
                                   if v.dtype == np.int32
                                   else torch.from_numpy(v)
                                   for k, v in b.items()}, cfg)
        assert loss.shape == () and loss.dtype == torch.float32
        losses.append(loss.item())
    return losses, st


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(4), JaxConfig(**DIMS)))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attn_impl", ["fast", "default"])
def test_fp32_o5_flow_matches_jax(tree, attn_impl, remat):
    kw = dict(attn_impl=attn_impl, remat=remat)
    batches = _batches()
    j_losses, j_master = _run_jax(tree, kw, batches, jnp.float32)
    p_losses, st = _run_port(tree, kw, batches, torch.float32)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5)
    assert amp.frontend._flat_masters_active(st)
    np.testing.assert_allclose(st.opt_state.master.numpy(), j_master,
                               atol=1e-5, rtol=0)
    assert p_losses[-1] < p_losses[0]
    assert all(l.dtype == torch.float32 for l in tree_leaves(st.model_params))


def test_bf16_o5_matches_jax(tree):
    kw = dict(attn_impl="fast", remat=True, dtype=None)
    batches = _batches()
    kw_j = dict(kw, dtype=jnp.bfloat16)
    kw_p = dict(kw, dtype=torch.bfloat16)
    j_losses, _ = _run_jax(tree, kw_j, batches, None)
    p_losses, st = _run_port(tree, kw_p, batches, None)
    np.testing.assert_allclose(p_losses, j_losses, rtol=2e-2)
    assert st.model_params["layers"]["wqkv"].dtype == torch.bfloat16
    assert st.opt_state.master.dtype == torch.float32
    assert float(st.loss_scale) == 1.0


def test_dropout_draws_one_seed_per_layer_and_repeats(tree):
    cfg = TransformerConfig(**DIMS, attn_impl="fast", dropout=0.1,
                            remat=True)
    params = params_from_jax(tree, device="cpu")
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in _batches()[0].items()}
    losses = [transformer_loss(params, batch, cfg,
                               dropout_rng=torch.Generator().manual_seed(s))
              for s in (3, 3, 4)]
    no_drop = transformer_loss(params, batch, cfg)
    assert losses[0].item() == losses[1].item()
    assert losses[0].item() != losses[2].item()
    assert losses[0].item() != no_drop.item()
    # remat recomputes each layer with the seed it drew in the forward
    p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
         for k, v in params.items()}
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss = transformer_loss(p, batch, c,
                                dropout_rng=torch.Generator().manual_seed(3))
        grads.append(torch.autograd.grad(loss, [p["layers"]["wqkv"]])[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)


ZERO_KW = dict(attn_impl="fast", remat=True)
ZERO_OPT = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0, impl="fused")


def _zero_batches(batch=4):
    """One synthetic MLM batch (15 % masked, weights on the masked
    positions), repeated each step, so the loss must fall."""
    rng = np.random.default_rng(33)
    tokens = rng.integers(0, DIMS["vocab_size"], (batch, S)).astype(np.int32)
    weights = (rng.random((batch, S)) < 0.15).astype(np.float32)
    b = dict(tokens=np.where(weights > 0, 0, tokens).astype(np.int32),
             targets=tokens, weights=weights)
    return [b] * STEPS


def _run_jax_zero(tree, batches, n_dev):
    """The BERT example's ``run_zero`` step at these widths."""
    cfg = JaxConfig(**DIMS, **ZERO_KW)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    opt = JaxZeroLAMB(**ZERO_OPT)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rep = jax.tree_util.tree_map(lambda _: P(), params)
    sspec = opt.state_pspecs()
    state = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(rep,),
                              out_specs=sspec))(params)

    @jax.jit
    def train_step(params, state, batch):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(rep, sspec, {k: P("data") for k in batch}),
            out_specs=(rep, sspec, P()), check_vma=False)
        def inner(p, s, local):
            loss, g = jax.value_and_grad(
                lambda p_: jax_loss(p_, local, cfg))(p)
            new_p, new_s = opt.step(s, g, p)
            return new_p, new_s, jax.lax.pmean(loss, "data")
        return inner(params, state, batch)

    losses = []
    for b in batches:
        params, state, loss = train_step(
            params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return losses, np.asarray(state.p)


def _check_zero(port, j_losses, j_master):
    per = j_master.shape[0] // len(port)
    for rank, (losses, shard) in enumerate(port):
        np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
        np.testing.assert_allclose(shard, j_master[rank * per:(rank + 1)
                                                   * per], atol=1e-5, rtol=0)
    assert port[0][0][-1] < port[0][0][0]


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_zero_step_world1_matches_jax(tree, tmp_path, monkeypatch, split):
    batches = _zero_batches()
    if split:
        monkeypatch.setenv("APEX_TPU_FLASH_BWD_FUSE", "0")
    j_losses, j_master = _run_jax_zero(tree, batches, 1)
    port = _torch_dist.run_in_process(
        _torch_dist.zero_train, tmp_path, tree, dict(DIMS, **ZERO_KW),
        batches, ZERO_OPT, split)
    _check_zero([port], j_losses, j_master)


def test_zero_step_world2_matches_jax(tree, tmp_path):
    batches = _zero_batches()
    j_losses, j_master = _run_jax_zero(tree, batches, 2)
    port = _torch_dist.run_ranks(
        _torch_dist.zero_train, 2, tmp_path, tree, dict(DIMS, **ZERO_KW),
        batches, ZERO_OPT, False)
    _check_zero(port, j_losses, j_master)


def test_mlp_fp16_steps_match_jax():
    sizes = [16, 32, 8]
    jmlp = JaxMLP(sizes, activation="relu", use_pallas=True)
    jp0 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float16),
                                 jmlp.init(jax.random.PRNGKey(5)))
    jp = jp0
    rng = np.random.default_rng(23)
    xs = [rng.standard_normal((12, 16)).astype(np.float16)
          for _ in range(STEPS)]
    xs[1][3, 4] = np.inf                     # step 2 overflows
    y = rng.random((12, 8)).astype(np.float32)

    jopt = JaxFP16(JaxAdam(lr=1e-2, impl="fused"), jp,
                   dynamic_loss_scale=True)

    def jloss(p, x):
        out = jmlp.apply(p, x).astype(jnp.float32)
        return jnp.mean((out - y) ** 2)

    j_losses, j_over, j_scale = [], [], []
    for x in xs:
        scale = jopt.loss_scale
        scaled, g = jax.value_and_grad(
            lambda p: jopt.scale_loss(jloss(p, jnp.asarray(x))))(jp)
        jp = jopt.step(g)
        j_losses.append(float(scaled) / scale)
        j_over.append(jopt.overflow)
        j_scale.append(jopt.loss_scale)

    mlp = MLP(sizes, activation="relu", use_pallas=True)
    pp = mlp_params_from_jax(jax.tree_util.tree_map(np.asarray, jp0),
                             device="cpu")
    popt = FP16_Optimizer(FusedAdam(lr=1e-2, impl="fused"), pp,
                          dynamic_loss_scale=True)
    p_losses, p_over, p_scale = [], [], []
    for x in xs:
        pp, loss = mlp_train_step(popt, pp, {"x": torch.from_numpy(x),
                                             "y": torch.from_numpy(y)}, mlp)
        assert loss.shape == () and loss.dtype == torch.float32
        p_losses.append(loss.item())
        p_over.append(popt.overflow)
        p_scale.append(popt.loss_scale)

    assert p_over == j_over == [False, True, False]
    assert p_scale == j_scale == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15]
    assert not np.isfinite(p_losses[1]) and not np.isfinite(j_losses[1])
    np.testing.assert_allclose([p_losses[0], p_losses[2]],
                               [j_losses[0], j_losses[2]], rtol=1e-3)
    np.testing.assert_allclose(popt.opt_state.master.numpy(),
                               np.asarray(jopt.opt_state.master), atol=1e-5,
                               rtol=0)
    for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=2.0 ** -10, atol=1e-4)
