"""BASELINE config 1 in the PyTorch port: the toy data-parallel example
under amp O1, against the JAX example's math.

``examples/simple/distributed/distributed_data_parallel.py`` trains a
2-layer MLP (512 -> 256 -> 32, global batch 64) under O1 with
``FusedSGD(lr=0.1, momentum=0.9)``, its batch sharded over a ``data`` mesh
axis.  Here its step runs on the full batch on one JAX device, and the
port's ``simple_ddp_train_step`` on two spawned gloo ranks
(``tests/_torch_dist.py``), each with half of the batch and the gradients
averaged over the group, from the same weights (the example's seed).
Three steps: the losses within 1e-4 relative, the loss scales equal, the
weights within 2e-4 of the model's largest |weight| on two ranks and 5e-5
in one process (fp16 products in both; on two ranks each half's fp16
gradients round before the average, ~6e-5 measured; one process gives
~3e-6, its losses ~5e-7).

Also the repair of ``resolve_group(())``: the JAX package's empty axis
tuple means "no collective", so ``sync_batch_norm(..., axis_name=())``
keeps per-rank statistics in a world of 2, as the JAX function does on
each device's rows.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as jax_bn

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel.mesh import resolve_group
from apex_tpu_torch.train import simple_ddp_train_step
from apex_tpu_torch.utils.device import from_numpy

import _torch_dist
from _torch_port import amp_uninit  # noqa: F401

D_IN, D_HIDDEN, D_OUT, BATCH = 512, 256, 32, 64


def _example_data(seed=0):
    """The example's parameters and regression problem, as numpy."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {
        "fc1": {"w": jax.random.normal(k1, (D_IN, D_HIDDEN))
                * (2.0 / D_IN) ** 0.5, "b": jnp.zeros((D_HIDDEN,))},
        "fc2": {"w": jax.random.normal(k2, (D_HIDDEN, D_OUT))
                * (1.0 / D_HIDDEN) ** 0.5, "b": jnp.zeros((D_OUT,))},
    }
    rng = np.random.RandomState(seed)
    X = rng.randn(BATCH, D_IN).astype(np.float32)
    W = rng.randn(D_IN, D_OUT).astype(np.float32) * 0.1
    return jax.tree_util.tree_map(np.asarray, params), X, X @ W


def _jax_steps(params, X, Y, steps):
    """The example's ``train_step`` on one device."""
    state = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, params),
                            JaxSGD(lr=0.1, momentum=0.9), opt_level="O1",
                            verbosity=0)

    @jax.jit
    def train_step(state, X, Y):
        def loss_fn(p):
            h = jax.nn.relu(jnp.matmul(state.cast_input(X), p["fc1"]["w"])
                            + p["fc1"]["b"])
            pred = jnp.matmul(h, p["fc2"]["w"]) + p["fc2"]["b"]
            loss = jnp.mean((pred.astype(jnp.float32) - Y) ** 2)
            return jamp.scale_loss(loss, state), loss

        grads, loss = jax.grad(loss_fn, has_aux=True)(state.model_params)
        return jamp.amp_step(state, grads), loss

    losses, scales = [], []
    for _ in range(steps):
        state, loss = train_step(state, jnp.asarray(X), jnp.asarray(Y))
        losses.append(float(loss))
        scales.append(float(state.loss_scale))
    return losses, scales, jax.tree_util.tree_map(np.asarray,
                                                  state.model_params)


def _close_weights(got, ref, tol):
    """Every leaf within ``tol`` of the model's largest |weight|."""
    top = max(np.abs(ref[k][n]).max() for k in ref for n in ref[k])
    for layer in ("fc1", "fc2"):
        for n in ("w", "b"):
            err = np.abs(got[layer][n] - ref[layer][n]).max()
            assert err <= tol * top, f"{layer}.{n}: {err:.3g}"


@pytest.fixture(scope="module")
def jax_reference():
    params, X, Y = _example_data()
    try:
        return params, X, Y, _jax_steps(params, X, Y, 3)
    finally:
        from apex_tpu.amp import amp as jamp_mod
        jamp_mod.uninit()


def test_simple_ddp_o1_two_ranks_match_the_jax_example(jax_reference,
                                                       tmp_path):
    params, X, Y, (j_losses, j_scales, j_params) = jax_reference
    res = _torch_dist.run_ranks(_torch_dist.simple_ddp_steps, 2, tmp_path,
                                params, X, Y, 3)
    for losses, scales, got in res:
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
        assert scales == j_scales
        _close_weights(got, j_params, 2e-4)
    assert j_losses[-1] < j_losses[0]
    # both ranks hold the same weights after the averaged steps
    for layer in ("fc1", "fc2"):
        np.testing.assert_array_equal(res[0][2][layer]["w"],
                                      res[1][2][layer]["w"])


def test_simple_ddp_o1_one_process_matches_the_jax_example(jax_reference):
    """No process group: the whole batch in one process, the step's
    reduction the identity."""
    params, X, Y, (j_losses, j_scales, j_params) = jax_reference
    st = amp.initialize(from_numpy(params, "cpu"),
                        FusedSGD(lr=0.1, momentum=0.9), opt_level="O1",
                        verbosity=0)
    assert amp.is_initialized()
    losses, scales = [], []
    for _ in range(3):
        st, loss = simple_ddp_train_step(st, torch.from_numpy(X),
                                         torch.from_numpy(Y), device="cpu")
        assert loss.dtype == torch.float32
        losses.append(float(loss))
        scales.append(float(st.loss_scale))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert scales == j_scales
    _close_weights({k: {n: t.numpy() for n, t in v.items()}
                    for k, v in st.model_params.items()}, j_params, 5e-5)


def test_simple_ddp_step_defaults_to_cuda():
    params, X, Y = _example_data()
    st = amp.initialize(from_numpy(params, "cpu"), FusedSGD(lr=0.1),
                        opt_level="O1", verbosity=0)
    with pytest.raises(RuntimeError):
        simple_ddp_train_step(st, torch.from_numpy(X), torch.from_numpy(Y))


def test_resolve_group_empty_axis_is_no_group():
    assert resolve_group(()) is None and resolve_group([]) is None


def test_sync_batch_norm_empty_axis_keeps_per_rank_stats(tmp_path):
    """In a gloo world of 2, ``axis_name=()`` normalises each rank's rows
    by their own statistics (the JAX function on those rows, within
    1e-5), not the world's."""
    x = np.random.default_rng(4).standard_normal(
        (8, 4, 4, 6)).astype(np.float32)
    x[4:] = 3.0 * x[4:] + 1.0            # the ranks' statistics differ
    res = _torch_dist.run_ranks(_torch_dist.syncbn_empty_axis, 2, tmp_path,
                                x)
    c = x.shape[-1]
    for rank, (out, rm, rv) in enumerate(res):
        rows = jnp.asarray(x[4 * rank:4 * rank + 4])
        jo, jm, jv = jax_bn(rows, jnp.ones(c), jnp.zeros(c), jnp.zeros(c),
                            jnp.ones(c), axis_name=(), training=True)
        np.testing.assert_allclose(out, np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(rm, np.asarray(jm), atol=1e-6)
        np.testing.assert_allclose(rv, np.asarray(jv), rtol=1e-5)
    assert np.abs(res[0][1] - res[1][1]).max() > 0.05
