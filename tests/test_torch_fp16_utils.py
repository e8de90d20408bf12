"""``fp16_utils`` of the PyTorch port: the legacy manual mixed-precision
API, mirroring ``tests/L0/test_fp16_utils.py`` case for case (network
conversion, param lists, the legacy scalers and their defaults, and the
legacy ``FP16_Optimizer`` flows: one shot, staged with a clip, overflow,
the closure retry, the unstaged guard, the stale stage, ``state_dict``),
each also run through the JAX package where it computes a number, the two
held to each other exactly (power-of-two scales, one SGD step of exact
values) or within 1e-6."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import fp16_utils as jfp16
from apex_tpu.optimizers import FusedSGD as JSGD

from apex_tpu_torch.fp16_utils import (
    DynamicLossScaler, FP16_Optimizer, LossScaler, convert_network,
    master_params_to_model_params, model_grads_to_master_grads,
    network_to_half, prep_param_lists, tofp16)
from apex_tpu_torch.multi_tensor_apply import TreeFlattener
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

CPU = "cpu"


def _params():
    return {"fc": {"w": torch.ones((8, 4)), "b": torch.zeros(4)},
            "bn": {"scale": torch.ones(4), "bias": torch.zeros(4)}}


def _jparams():
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                  _params())


def test_network_conversion_and_bn_safety():
    p = _params()
    half = network_to_half(p)
    assert all(l.dtype == torch.float16 for l in tree_leaves(half))
    assert tofp16(p)["fc"]["w"].dtype == torch.float16
    conv = convert_network(p, torch.float16, keep_batchnorm_fp32=True)
    assert conv["fc"]["w"].dtype == torch.float16
    assert conv["bn"]["scale"].dtype == torch.float32
    # the JAX package keeps the same leaves fp32
    jconv = jfp16.convert_network(_jparams(), jnp.float16, True)
    assert [str(l.dtype) for l in jax.tree_util.tree_leaves(jconv)] == \
        [str(l.dtype).replace("torch.", "") for l in tree_leaves(conv)]


def test_prep_param_lists_and_copies():
    p = network_to_half(_params())
    model, master = prep_param_lists(p)
    assert all(l.dtype == torch.float32 for l in tree_leaves(master))
    g32 = model_grads_to_master_grads(tree_map(torch.ones_like, model))
    assert all(l.dtype == torch.float32 for l in tree_leaves(g32))
    back = master_params_to_model_params(model, master)
    assert back["fc"]["w"].dtype == torch.float16

    model, (fl, flat) = prep_param_lists(p, flat_master=True)
    assert isinstance(fl, TreeFlattener)
    assert flat.dtype == torch.float32 and flat.dim() == 1
    # the same flat layout as the JAX package's
    _, (_, jflat) = jfp16.prep_param_lists(
        jfp16.network_to_half(_jparams()), flat_master=True)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = master_params_to_model_params(model, (fl, flat))
    assert back["fc"]["w"].dtype == torch.float16
    np.testing.assert_array_equal(back["fc"]["w"].float().numpy(),
                                  model["fc"]["w"].float().numpy())


def test_loss_scalers_legacy_api_and_defaults():
    s = LossScaler(128.0, device=CPU)
    assert s.loss_scale == 128.0
    assert float(s.backward(torch.tensor(2.0))) == 256.0
    g = s.scale_gradient({"w": torch.full((4,), 128.0)})
    np.testing.assert_array_equal(g["w"].numpy(), 1.0)
    s.update_scale(False)                 # static: no-op
    assert s.loss_scale == 128.0

    d = DynamicLossScaler(device=CPU)     # legacy defaults 2**32 / 1000
    jd = jfp16.DynamicLossScaler()
    assert d.loss_scale == jd.loss_scale == 2.0 ** 32
    assert d.state.scale_window == jd.state.scale_window == 1000
    assert d.has_overflow({"w": torch.tensor([float("inf")])})
    assert not d.has_overflow({"w": torch.tensor([1.0])})
    d.update_scale(True)
    jd.update_scale(True)
    assert d.loss_scale == jd.loss_scale == 2.0 ** 31
    d.update_scale(torch.tensor(False))
    assert d.loss_scale == 2.0 ** 31


def _quadratic_setup(scale=64.0):
    params = {"w": torch.full((4,), 4.0)}
    opt = FP16_Optimizer(FusedSGD(lr=0.5), params, static_loss_scale=scale)

    def scaled_grads(masters):
        # d/dw of 0.5*w^2 = w, scaled the way .backward() would
        return tree_map(lambda w: w * scale, masters)
    return opt, scaled_grads


def test_fp16_optimizer_one_shot_step_descends():
    opt, sg = _quadratic_setup()
    jopt = jfp16.FP16_Optimizer(JSGD(lr=0.5), {"w": jnp.full((4,), 4.0)},
                                static_loss_scale=64.0)
    for _ in range(3):
        opt.step(sg(opt.master_params))
        jopt.step(jax.tree_util.tree_map(lambda w: w * 64.0,
                                         jopt.master_params))
    np.testing.assert_array_equal(opt.master_params["w"].numpy(), 0.5)
    np.testing.assert_array_equal(opt.master_params["w"].numpy(),
                                  np.asarray(jopt.master_params["w"]))
    assert not opt.overflow


def test_fp16_optimizer_staged_flow_with_clip():
    opt, sg = _quadratic_setup()
    g32 = opt.update_master_grads(sg(opt.master_params))
    np.testing.assert_array_equal(g32["w"].numpy(), 4.0)   # unscaled
    clipped, norm = opt.clip_master_grads(g32, max_norm=1.0)
    assert float(norm) == pytest.approx(8.0)                # ||(4,4,4,4)||
    opt.step(grads32=clipped)
    np.testing.assert_allclose(opt.master_params["w"].numpy(), 3.75,
                               rtol=1e-6)

    opt.update_master_grads(sg(opt.master_params))
    opt.step()
    np.testing.assert_allclose(opt.master_params["w"].numpy(), 3.75 / 2,
                               rtol=1e-6)
    with pytest.raises(RuntimeError, match="update_master_grads"):
        opt.step()                                          # nothing staged


def test_fp16_optimizer_overflow_skips_and_halves():
    params = {"w": torch.ones(4)}
    opt = FP16_Optimizer(FusedSGD(lr=0.1), params, dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 16})
    opt.step({"w": torch.full((4,), float("inf"))})
    assert opt.overflow
    np.testing.assert_array_equal(opt.master_params["w"].numpy(), 1.0)
    assert opt.loss_scale == 2.0 ** 15


def test_fp16_optimizer_closure_retries_until_finite():
    params = {"w": torch.full((4,), 4.0)}
    opt = FP16_Optimizer(FusedSGD(lr=0.5), params, dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 16})
    calls = {"n": 0}

    def closure():
        calls["n"] += 1
        s = opt.loss_scale
        if s > 2.0 ** 14:               # "overflows" until the scale drops
            return {"w": torch.full((4,), float("inf"))}
        return tree_map(lambda w: w * s, opt.master_params)

    opt.step(closure=closure)
    assert calls["n"] == 3              # 2 overflow retries + 1 success
    np.testing.assert_array_equal(opt.master_params["w"].numpy(), 2.0)

    with pytest.raises(FloatingPointError, match="20 loss-scale"):
        opt.step(closure=lambda: {"w": torch.full((4,), float("inf"))})


def test_fp16_optimizer_unstaged_grads32_still_guarded():
    params = {"w": torch.ones(4)}
    opt = FP16_Optimizer(FusedSGD(lr=0.1), params, dynamic_loss_scale=True)
    opt.step(grads32={"w": torch.full((4,), float("inf"))})
    assert opt.overflow
    np.testing.assert_array_equal(opt.master_params["w"].numpy(), 1.0)


def test_fp16_optimizer_closure_static_scale_skips_not_raises():
    params = {"w": torch.ones(4)}
    opt = FP16_Optimizer(FusedSGD(lr=0.1), params, static_loss_scale=64.0)
    calls = {"n": 0}

    def closure():
        calls["n"] += 1
        return {"w": torch.full((4,), float("inf"))}

    opt.step(closure=closure)
    assert calls["n"] == 1 and opt.overflow
    np.testing.assert_array_equal(opt.master_params["w"].numpy(), 1.0)


def test_fp16_optimizer_one_shot_clears_stale_stage():
    opt, sg = _quadratic_setup()
    opt.update_master_grads(sg(opt.master_params))
    opt.step(sg(opt.master_params))          # one-shot path
    with pytest.raises(RuntimeError, match="update_master_grads"):
        opt.step()                           # the stale stage is gone


def test_fp16_optimizer_state_dict_roundtrip():
    opt, sg = _quadratic_setup()
    opt.step(sg(opt.master_params))
    blob = opt.state_dict()
    opt2, _ = _quadratic_setup()
    opt2.load_state_dict(blob)
    np.testing.assert_array_equal(opt2.master_params["w"].numpy(),
                                  opt.master_params["w"].numpy())
    assert opt2.loss_scale == opt.loss_scale


def test_fp16_optimizer_fp16_model_matches_jax():
    """An fp16 model over several dynamic-scale steps, one overflowing:
    the same fp16 params, fp32 masters and scales as the JAX package."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((6, 5)).astype(np.float16),
          "b": rng.standard_normal(5).astype(np.float16)}
    opt = FP16_Optimizer(FusedSGD(lr=0.1, momentum=0.9),
                         {k: torch.from_numpy(v) for k, v in p0.items()},
                         dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 10,
                                            "scale_window": 2})
    jopt = jfp16.FP16_Optimizer(JSGD(lr=0.1, momentum=0.9),
                                {k: jnp.asarray(v) for k, v in p0.items()},
                                dynamic_loss_scale=True,
                                dynamic_loss_args={"init_scale": 2.0 ** 10,
                                                   "scale_window": 2})
    for step in range(5):
        g = {k: (rng.standard_normal(v.shape) * opt.loss_scale
                 ).astype(np.float32) for k, v in p0.items()}
        if step == 2:
            g["a"][0, 0] = np.inf
        out = opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        jout = jopt.step({k: jnp.asarray(v) for k, v in g.items()})
        assert opt.overflow == jopt.overflow == (step == 2)
        assert opt.loss_scale == jopt.loss_scale
    for k in p0:
        assert out[k].dtype == torch.float16
        np.testing.assert_array_equal(out[k].numpy(),
                                      np.asarray(jout[k]))
        np.testing.assert_allclose(opt.master_params[k].numpy(),
                                   np.asarray(jopt.master_params[k]),
                                   rtol=0, atol=1e-6)
