"""The contrib FP16_Optimizer of the PyTorch port against the JAX package.

The flow of ``tests/L0/test_misc_parity.py::test_contrib_fp16_optimizer_flat``
on the port: a non-fused optimizer is refused (ValueError); one step on
scaled gradients equals plain fused FusedAdam on the unscaled ones (1e-6);
an inf gradient skips the step, keeps the params and halves the scale; the
state_dict round trip keeps the scale.  Then the port and the JAX package
run the same fp16 parameters and scaled fp16 gradients (one step with an
inf) through FP16_Optimizer(FusedAdam(impl="fused")) side by side: the
overflow flags and loss scales are the same at every step, the flat fp32
masters within 1e-6 and the fp16 model copies within one fp16 step
(2^-10 relative).  The unscale runs through ``multi_tensor_scale`` (its
plain version here).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.optimizers import FP16_Optimizer as JaxFP16
from apex_tpu.optimizers import FusedAdam as JaxAdam

from apex_tpu_torch.contrib.optimizers import FP16_Optimizer
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.utils.pytree import tree_leaves


def _params():
    w = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    return {"w": torch.from_numpy(w)}


def test_refuses_unfused_optimizers():
    with pytest.raises(ValueError):
        FP16_Optimizer(FusedAdam(lr=1e-2, impl="xla"), _params())
    with pytest.raises(ValueError):
        FP16_Optimizer(FusedLAMB(impl="xla"), _params())


def test_step_skip_and_state_dict():
    params = _params()
    opt = FP16_Optimizer(FusedAdam(lr=1e-2, impl="fused"), params,
                         dynamic_loss_scale=True)
    scale = opt.loss_scale
    assert scale == 2.0 ** 16
    p1 = opt.step({"w": torch.full((16, 8), 0.1) * scale})
    assert not opt.overflow
    ref_opt = FusedAdam(lr=1e-2, impl="fused")
    pref, _ = ref_opt.step(ref_opt.init(params),
                           {"w": torch.full((16, 8), 0.1)}, params)
    np.testing.assert_allclose(p1["w"].numpy(), pref["w"].numpy(),
                               atol=1e-6)
    count = int(opt.opt_state.count)

    p2 = opt.step({"w": torch.full((16, 8), float("inf"))})
    assert opt.overflow and opt.loss_scale == scale / 2
    assert torch.equal(p2["w"], p1["w"])
    assert int(opt.opt_state.count) == count          # the count is kept too

    sd = opt.state_dict()
    assert sd["overflow"] and sd["loss_scaler"]["loss_scale"] == scale / 2
    opt2 = FP16_Optimizer(FusedAdam(lr=1e-2, impl="fused"), params)
    assert opt2.loss_scale == 1.0                       # static default
    opt2.load_state_dict(sd)
    assert opt2.loss_scale == opt.loss_scale and opt2.overflow
    assert opt2.scaler_state.dynamic
    assert torch.equal(opt2.model_params()["w"], p1["w"])


def test_clip_master_grads():
    opt = FP16_Optimizer(FusedAdam(impl="fused"), _params())
    grads = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = opt.clip_master_grads(grads, 1.0)
    np.testing.assert_allclose(float(norm), 10.0, rtol=1e-6)
    total = torch.sqrt(sum((g ** 2).sum() for g in clipped.values()))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    same, _ = opt.clip_master_grads(grads, 100.0)
    assert torch.equal(same["a"], grads["a"])


def test_fp16_steps_match_jax():
    rng = np.random.default_rng(9)
    shapes = {"w1": (24, 16), "b1": (16,), "w2": (16, 8)}
    p16 = {k: rng.standard_normal(s).astype(np.float16)
           for k, s in shapes.items()}
    jopt = JaxFP16(JaxAdam(lr=1e-3, weight_decay=0.01, impl="fused"),
                   jax.tree_util.tree_map(jnp.asarray, p16),
                   dynamic_loss_scale=True,
                   dynamic_loss_args={"scale_window": 2})
    popt = FP16_Optimizer(FusedAdam(lr=1e-3, weight_decay=0.01,
                                    impl="fused"),
                          {k: torch.from_numpy(v) for k, v in p16.items()},
                          dynamic_loss_scale=True,
                          dynamic_loss_args={"scale_window": 2})
    for step in range(5):
        scale = jopt.loss_scale
        g = {k: (rng.standard_normal(s) * 1e-3 * scale).astype(np.float16)
             for k, s in shapes.items()}
        if step == 2:
            g["b1"][3] = np.inf
        jp = jopt.step(jax.tree_util.tree_map(jnp.asarray, g))
        pp = popt.step({k: torch.from_numpy(v) for k, v in g.items()})
        assert popt.overflow == jopt.overflow == (step == 2)
        assert popt.loss_scale == jopt.loss_scale
        np.testing.assert_allclose(popt.opt_state.master.numpy(),
                                   np.asarray(jopt.opt_state.master),
                                   atol=1e-6, rtol=0)
        for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
            assert a.dtype == torch.float16
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=2.0 ** -10, atol=1e-7)
    # steps 0-1 double the scale (window 2), step 2 halves it, 3-4 double
    assert popt.loss_scale == 2.0 ** 17
