"""Weight norm of the PyTorch port against the JAX package (the
counterpart of ``tests/L0/test_misc_parity.py``'s weight-norm tests).

The same numpy weights go to ``apex_tpu.reparameterization`` and to
``apex_tpu_torch.reparameterization``; the weights, the (g, v) pairs and
the gradients of g and v (autograd here, ``jax.grad`` there) agree to
1e-6 (fp32, one norm summed in other orders).  An fp16 v gives its weight
in fp16 from an fp32 norm, in both packages.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.reparameterization import (apply_weight_norm as j_apply,
                                         compute_weight as j_compute,
                                         compute_weights as j_computes,
                                         init_weight_norm as j_init,
                                         remove_weight_norm as j_remove)

from apex_tpu_torch.reparameterization import (apply_weight_norm,
                                               compute_weight,
                                               compute_weights,
                                               init_weight_norm,
                                               remove_weight_norm)
from apex_tpu_torch.utils.device import from_numpy
from apex_tpu_torch.utils.pytree import tree_leaves


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_weight_norm_matches_torch_and_jax(dim):
    torch.manual_seed(0)
    lin = torch.nn.Linear(6, 10, bias=False)
    wn = torch.nn.utils.weight_norm(lin, dim=dim % 2)
    v = wn.weight_v.detach()                      # (out=10, in=6)
    g = wn.weight_g.detach()
    ours = compute_weight(g, v, dim=dim)
    np.testing.assert_allclose(ours.numpy(), wn.weight.detach().numpy(),
                               atol=1e-6)
    jax_w = j_compute(jnp.asarray(g.numpy()), jnp.asarray(v.numpy()), dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_w), atol=1e-6)


def test_apply_remove_round_trip_and_grads():
    w = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
    np_params = {"fc": {"w": w, "b": np.zeros(4, np.float32)},
                 "head": {"weight": w[:4], "kernel1": w[:, :2]}}
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = from_numpy(np_params, device="cpu")
    j_wn, j_spec = j_apply(jp, names=("w", "weight"), dim=0)
    wn_params, spec = apply_weight_norm(tp, names=("w", "weight"), dim=0)
    assert spec == j_spec == {"fc/w": 0, "head/weight": 0}
    assert set(wn_params["fc"]["w"]) == {"weight_g", "weight_v"}
    assert torch.equal(wn_params["head"]["kernel1"], tp["head"]["kernel1"])
    for a, b in zip(tree_leaves(wn_params), jax.tree_util.tree_leaves(j_wn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    back = remove_weight_norm(wn_params, spec)
    np.testing.assert_allclose(back["fc"]["w"].numpy(), w, atol=1e-6)
    assert torch.equal(back["fc"]["b"], tp["fc"]["b"])
    np.testing.assert_allclose(back["fc"]["w"].numpy(),
                               np.asarray(j_remove(j_wn, j_spec)["fc"]["w"]),
                               atol=1e-6)

    # gradients reach g and v, and equal jax.grad's
    def j_loss(p):
        return jnp.sum(j_computes(p, j_spec)["fc"]["w"] ** 3)

    jg = jax.grad(j_loss)(j_wn)
    gv = [wn_params["fc"]["w"]["weight_g"].requires_grad_(True),
          wn_params["fc"]["w"]["weight_v"].requires_grad_(True)]
    (compute_weights(wn_params, spec)["fc"]["w"] ** 3).sum().backward()
    for t, name in zip(gv, ("weight_g", "weight_v")):
        assert float(t.grad.abs().sum()) > 0
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(jg["fc"]["w"][name]),
                                   rtol=1e-5, atol=1e-6)


def test_weight_norm_dim_none():
    w = np.random.default_rng(3).standard_normal((5, 4)).astype(np.float32)
    gv = init_weight_norm(torch.from_numpy(w), dim=None)
    jgv = j_init(jnp.asarray(w), dim=None)
    assert gv["weight_g"].shape == () == jgv["weight_g"].shape
    np.testing.assert_allclose(gv["weight_g"].numpy(),
                               np.asarray(jgv["weight_g"]), rtol=1e-6)
    np.testing.assert_allclose(
        compute_weight(gv["weight_g"], gv["weight_v"], None).numpy(), w,
        atol=1e-6)


def test_fp16_weight_from_an_fp32_norm():
    """An fp16 (g, v) pair, as the byte mLSTM's fp16 model holds it: the
    weight comes back in fp16, equal to the JAX package's."""
    w = (np.random.default_rng(4).standard_normal((16, 8)) * 3).astype(
        np.float32)
    tv, jv = torch.from_numpy(w).half(), jnp.asarray(w).astype(jnp.float16)
    tgv, jgv = init_weight_norm(tv, 0), j_init(jv, 0)
    assert tgv["weight_g"].dtype == torch.float16
    np.testing.assert_array_equal(tgv["weight_g"].float().numpy(),
                                  np.asarray(jgv["weight_g"], np.float32))
    got = compute_weight(tgv["weight_g"], tv, 0)
    ref = j_compute(jgv["weight_g"], jv, 0)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-3,
                               atol=1e-3)
