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
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.models import transformer_loss as jax_loss
from apex_tpu.optimizers import FusedLAMB as JaxLAMB

from apex_tpu_torch import amp
from apex_tpu_torch.models import (TransformerConfig, params_from_jax,
                                   transformer_loss)
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.train import train_step
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
