"""DCGAN (BASELINE config 5) in the PyTorch port against the JAX package.

At width 8 (``feat_g = feat_d = 8``, latent 100, 3 channels, 64 x 64) and
from the same weights (``dcgan_params_from_jax``): the generator's and the
discriminator's outputs and new batch-norm statistics match
``apex_tpu.models.dcgan`` within 1e-5 in fp32 and 2e-2 (of max(1, |x|))
under O4's bf16 casts; every transposed convolution, 1 x 1 -> 4 x 4 and
each stride-2 layer, matches ``lax.conv_transpose(..., transpose_kernel=
False)`` only with the kernel's taps reversed; the discriminator's "SAME"
convolutions match XLA's pads.

The train step is local to ``main`` in ``examples/dcgan/main_amp.py``, so
the JAX reference here writes the same step from ``apex_tpu.amp`` and
``apex_tpu.models.dcgan`` (the example is left as it is).  3 fp32 steps of
``dcgan_train_step`` (two FusedAdam(lr=2e-4, betas=(0.5, 0.999)), D with
two losses, G with one) against it: losses within 1e-5 relative, the
parameters and running statistics within 1e-5 of max(1, |x|) (measured:
~3e-7 and ~4e-7); under O4 one step, losses within 2e-2, every scale
1.0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import dcgan as J
from apex_tpu.optimizers import FusedAdam as JaxAdam

from apex_tpu_torch import amp
from apex_tpu_torch.models import dcgan as P
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.train import dcgan_train_step
from apex_tpu_torch.utils.pytree import tree_leaves_with_path, tree_map

from _torch_port import amp_uninit  # noqa: F401

W = 8                 # feat_g = feat_d
BATCH = 4


def _cfgs(dtype="float32"):
    return (J.DCGANConfig(feat_g=W, feat_d=W, dtype=getattr(jnp, dtype)),
            P.DCGANConfig(feat_g=W, feat_d=W, dtype=getattr(torch, dtype)))


@pytest.fixture(scope="module")
def weights():
    cj, _ = _cfgs()
    pj, bj = J.dcgan_init(jax.random.PRNGKey(0), cj)
    return (jax.tree_util.tree_map(np.asarray, pj),
            jax.tree_util.tree_map(np.asarray, bj))


def _batch(seed, batch=BATCH):
    rng = np.random.RandomState(seed)
    real = rng.rand(batch, 64, 64, 3).astype(np.float32) * 2.0 - 1.0
    z = rng.randn(batch, 100).astype(np.float32)
    return real, z


def _to_jax_layout(tree):
    """The port's params back in the JAX package's HWIO layout, numpy."""
    def conv(path, t):
        name = path[-1]
        t = t.detach().float()
        if name.startswith("deconv"):
            return torch.flip(t.permute(2, 3, 0, 1), (0, 1)).numpy()
        if name.startswith("conv"):
            return t.permute(2, 3, 1, 0).numpy()
        return t.numpy()
    return {path: conv(path, t) for path, t in tree_leaves_with_path(tree)}


def _jax_flat(tree):
    return {tuple(k.key for k in path): np.asarray(v, np.float32) for path, v
            in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, ref, tol, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    lim = tol * np.maximum(1.0, np.abs(np.asarray(ref, np.float64)))
    assert (err <= lim).all(), f"{what}: max err {err.max():.3g}"


def test_dcgan_tree_shapes_and_parameters(weights):
    """The JAX tree paths letter for letter; the same parameter count;
    HWIO kernels in the port's layouts; a seed gives the same weights."""
    pj, bj = weights
    _, cp = _cfgs()
    pp, bp = P.dcgan_init(torch.Generator().manual_seed(0), cp,
                          device="cpu")
    pp2, _ = P.dcgan_init(torch.Generator().manual_seed(0), cp,
                          device="cpu")
    jp = _jax_flat(pj)
    port = dict(tree_leaves_with_path(pp))
    assert set(jp) == set(port)
    assert set(_jax_flat(bj)) == set(dict(tree_leaves_with_path(bp)))
    assert sum(v.size for v in jp.values()) == \
        sum(t.numel() for t in port.values())
    for path, t in port.items():
        hwio = jp[path].shape
        if path[-1].startswith("deconv"):
            assert tuple(t.shape) == (hwio[2], hwio[3], hwio[0], hwio[1])
        elif path[-1].startswith("conv"):
            assert tuple(t.shape) == (hwio[3], hwio[2], hwio[0], hwio[1])
        else:
            assert tuple(t.shape) == hwio
        assert t.dtype == torch.float32
        assert torch.equal(t, dict(tree_leaves_with_path(pp2))[path])
    assert abs(float(port[("gen", "deconv1")].std()) - 0.02) < 2e-3
    with pytest.raises(RuntimeError):
        P.dcgan_init(torch.Generator().manual_seed(0), cp)   # default cuda
    # the conversion from the JAX package is its own inverse's inverse
    conv, _ = P.dcgan_params_from_jax(pj, bj, device="cpu")
    back = _to_jax_layout(conv)
    for path, v in jp.items():
        np.testing.assert_array_equal(back[path], v)


@pytest.mark.parametrize("mode", ["fp32", "o4_bf16"])
def test_generator_and_discriminator_match_jax(weights, mode):
    pj, bj = weights
    dtype = "float32" if mode == "fp32" else "bfloat16"
    tol = 1e-5 if mode == "fp32" else 2e-2
    cj, cp = _cfgs(dtype)
    pp, bp = P.dcgan_params_from_jax(pj, bj, device="cpu")
    real, z = _batch(1)
    jargs = jax.tree_util.tree_map(jnp.asarray, (pj, bj))
    if mode == "o4_bf16":
        from apex_tpu.amp import amp as jamp_mod
        with jamp_mod.autocast(jnp.bfloat16):
            jimg, jbn = J.generator_apply(*jargs, jnp.asarray(z), cj)
            jlog, jbn2 = J.discriminator_apply(*jargs, jnp.asarray(real), cj)
        with amp.autocast(torch.bfloat16):
            img, bn = P.generator_apply(pp, bp, torch.from_numpy(z), cp)
            log, bn2 = P.discriminator_apply(pp, bp, torch.from_numpy(real),
                                             cp)
    else:
        jimg, jbn = J.generator_apply(*jargs, jnp.asarray(z), cj)
        jlog, jbn2 = J.discriminator_apply(*jargs, jnp.asarray(real), cj)
        img, bn = P.generator_apply(pp, bp, torch.from_numpy(z), cp)
        log, bn2 = P.discriminator_apply(pp, bp, torch.from_numpy(real), cp)
    assert tuple(img.shape) == (BATCH, 64, 64, 3) == jimg.shape
    assert img.dtype == getattr(torch, dtype)
    assert log.dtype == torch.float32 and tuple(log.shape) == (BATCH,)
    _close(img.float().numpy(), np.asarray(jimg, np.float32), tol, "images")
    _close(log.numpy(), np.asarray(jlog), tol, "logits")
    for got, ref in ((bn["gen"], jbn["gen"]), (bn2["disc"], jbn2["disc"])):
        for k in ref:
            for s in ("mean", "var"):
                _close(got[k][s].numpy(), np.asarray(ref[k][s]), tol,
                       f"{k}.{s}")


_DECONVS = [("deconv0", 1, 100, 8 * W, (1, 1), "VALID"),
            ("deconv1", 4, 8 * W, 4 * W, (2, 2), "SAME"),
            ("deconv2", 8, 4 * W, 2 * W, (2, 2), "SAME"),
            ("deconv3", 16, 2 * W, W, (2, 2), "SAME"),
            ("deconv4", 32, W, 3, (2, 2), "SAME")]


@pytest.mark.parametrize("layer", _DECONVS, ids=[d[0] for d in _DECONVS])
def test_transposed_convolution_reverses_the_taps(layer):
    """``F.conv_transpose2d`` with ``deconv_weight`` (taps reversed) is the
    JAX model's ``lax.conv_transpose(..., transpose_kernel=False)`` within
    1e-5; the same kernel without the reversal is not."""
    name, size, cin, cout, strides, pad = layer
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 4, cin, cout))).astype(np.float32)
    ref = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), strides, pad,
        dimension_numbers=J.DN))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    padding = 0 if pad == "VALID" else 1
    out = torch.nn.functional.conv_transpose2d(
        xt, P.deconv_weight(torch.from_numpy(w)), stride=strides,
        padding=padding).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 4 if size == 1 else 2 * size,
                                      4 if size == 1 else 2 * size, cout)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    unflipped = torch.nn.functional.conv_transpose2d(
        xt, torch.from_numpy(w).permute(2, 3, 0, 1), stride=strides,
        padding=padding).permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - ref).max() > 1e-2


_CONVS = [("conv0", 64, 3, W, 2, "SAME"), ("conv1", 32, W, 2 * W, 2, "SAME"),
          ("conv2", 16, 2 * W, 4 * W, 2, "SAME"),
          ("conv3", 8, 4 * W, 8 * W, 2, "SAME"),
          ("conv4", 4, 8 * W, 1, 1, "VALID")]


@pytest.mark.parametrize("layer", _CONVS, ids=[c[0] for c in _CONVS])
def test_discriminator_convolutions_pad_as_xla(layer):
    """XLA's "SAME" at k 4, stride 2 on an even size pads (1, 1): the
    port's ``padding=1`` gives ``conv_general_dilated``'s output within
    1e-5."""
    name, size, cin, cout, stride, pad = layer
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 4, cin, cout))).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), pad,
        dimension_numbers=J.DN))
    out = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        P.conv_weight(torch.from_numpy(w)), stride=stride,
        padding=1 if pad == "SAME" else 0).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _bce(logits, target):
    return jnp.mean(jnp.maximum(logits, 0) - logits * target
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def _jax_train_step(cfg):
    """The example's ``train_step`` (``main_amp.py:72-117``)."""
    @jax.jit
    def train_step(stateD, stateG, bn_state, real_images, z):
        P_ = lambda sD, sG: {"disc": sD.model_params, "gen": sG.model_params}
        fake_images, bn1 = J.generator_apply(P_(stateD, stateG), bn_state, z,
                                             cfg, train=True)
        fake_images = jax.lax.stop_gradient(fake_images)

        def d_real_loss(dp):
            logits, bn_r = J.discriminator_apply(
                {"disc": dp, "gen": stateG.model_params}, bn1,
                real_images, cfg, train=True)
            return jamp.scale_loss(_bce(logits, 1.0), stateD,
                                   loss_id=0), (logits, bn_r)

        gr, (logits_real, bn_r) = jax.grad(d_real_loss, has_aux=True)(
            stateD.model_params)

        def d_fake_loss(dp):
            logits, bn2 = J.discriminator_apply(
                {"disc": dp, "gen": stateG.model_params}, bn_r,
                fake_images, cfg, train=True)
            return jamp.scale_loss(_bce(logits, 0.0), stateD,
                                   loss_id=1), bn2

        gf, bn2 = jax.grad(d_fake_loss, has_aux=True)(stateD.model_params)
        errD_real = _bce(logits_real, 1.0)
        new_stateD = jamp.amp_step_multi(stateD, [(gr, 0), (gf, 1)])

        def g_loss(gp):
            imgs, bn3 = J.generator_apply(
                {"disc": new_stateD.model_params, "gen": gp}, bn2, z, cfg,
                train=True)
            logits, bn4 = J.discriminator_apply(
                {"disc": new_stateD.model_params, "gen": gp}, bn3, imgs,
                cfg, train=True)
            loss = _bce(logits, 1.0)
            return jamp.scale_loss(loss, stateG, loss_id=0), (loss, bn4)

        gg, (errG, bn4) = jax.grad(g_loss, has_aux=True)(stateG.model_params)
        new_stateG = jamp.amp_step(stateG, gg, loss_id=0)
        return new_stateD, new_stateG, bn4, errD_real, errG
    return train_step


def _adam():
    return dict(lr=2e-4, betas=(0.5, 0.999))


def _run(weights, level, steps):
    pj, bj = weights
    dtype = "float32" if level == "O0" else "bfloat16"
    cj, cp = _cfgs(dtype)
    jD = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, pj["disc"]),
                         JaxAdam(**_adam()), opt_level=level, num_losses=2,
                         verbosity=0)
    jG = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, pj["gen"]),
                         JaxAdam(**_adam()), opt_level=level, verbosity=0)
    jbn = jax.tree_util.tree_map(jnp.asarray, bj)
    pp, bp = P.dcgan_params_from_jax(pj, bj, device="cpu")
    sD = amp.initialize(pp["disc"], FusedAdam(**_adam()), opt_level=level,
                        num_losses=2, verbosity=0)
    sG = amp.initialize(pp["gen"], FusedAdam(**_adam()), opt_level=level,
                        verbosity=0)
    step = _jax_train_step(cj)
    out = []
    for i in range(steps):
        real, z = _batch(10 + i)
        jD, jG, jbn, jerr_d, jerr_g = step(jD, jG, jbn, jnp.asarray(real),
                                           jnp.asarray(z))
        sD, sG, bp, err_d, err_f, err_g = dcgan_train_step(
            sD, sG, bp, torch.from_numpy(real), torch.from_numpy(z), cp,
            device="cpu")
        assert np.isfinite(float(err_f))
        out.append(((float(jerr_d), float(jerr_g)),
                    (float(err_d), float(err_g))))
    return out, (jD, jG, jbn), (sD, sG, bp)


def test_dcgan_train_step_matches_jax_fp32(weights):
    losses, (jD, jG, jbn), (sD, sG, bp) = _run(weights, "O0", 3)
    for (jd, jg), (d, g) in losses:
        assert abs(d - jd) <= 1e-5 * abs(jd) and abs(g - jg) <= 1e-5 * abs(jg)
    for st, js in ((sD, jD), (sG, jG)):
        assert [float(s.loss_scale) for s in st.scalers] == \
            [float(s.loss_scale) for s in js.scalers]
    got = _to_jax_layout({"disc": sD.model_params, "gen": sG.model_params})
    ref = _jax_flat({"disc": jD.model_params, "gen": jG.model_params})
    for path, v in ref.items():
        _close(got[path], v, 1e-5, "/".join(path))
    got_bn = dict(tree_leaves_with_path(tree_map(lambda t: t.numpy(), bp)))
    for path, v in _jax_flat(jbn).items():
        _close(got_bn[path], v, 1e-5, "/".join(path))
    start = _jax_flat(weights[0])
    moved = max(np.abs(got[p] - start[p]).max() for p in start)
    assert moved > 1e-4


def test_dcgan_train_step_matches_jax_o4(weights):
    """O4: bf16 casts, loss scale 1 on all three scalers, no skipped step;
    one step's losses within 2e-2 of the JAX package's."""
    losses, (jD, jG, _), (sD, sG, _) = _run(weights, "O4", 1)
    (jd, jg), (d, g) = losses[0]
    assert abs(d - jd) <= 2e-2 * max(1.0, abs(jd))
    assert abs(g - jg) <= 2e-2 * max(1.0, abs(jg))
    scales = [float(s.loss_scale) for s in sD.scalers + sG.scalers]
    assert scales == [1.0, 1.0, 1.0]
    assert not any(s.dynamic for s in sD.scalers + sG.scalers)
    assert int(sD.opt_state.count) == 1 == int(sG.opt_state.count)
    assert amp.is_initialized()


def test_dcgan_train_step_defaults_to_cuda(weights):
    pj, bj = weights
    _, cp = _cfgs()
    pp, bp = P.dcgan_params_from_jax(pj, bj, device="cpu")
    sD = amp.initialize(pp["disc"], FusedAdam(**_adam()), opt_level="O0",
                        num_losses=2, verbosity=0)
    sG = amp.initialize(pp["gen"], FusedAdam(**_adam()), opt_level="O0",
                        verbosity=0)
    real, z = _batch(0)
    with pytest.raises(RuntimeError):
        dcgan_train_step(sD, sG, bp, torch.from_numpy(real),
                         torch.from_numpy(z), cp)
