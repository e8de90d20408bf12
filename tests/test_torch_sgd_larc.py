"""FusedSGD and LARC of the PyTorch port against the JAX package's.

FusedSGD: the grid of the JAX package's ``test_sgd_vs_torch`` (impl "xla"
and "fused" x momentum 0 / 0.9, nesterov, weight decay 1e-4), plus
dampening (xla only: the fused impl refuses it, as the JAX one does),
``wd_after_momentum``, a gradient ``scale`` and a learning-rate schedule.
Seven steps over three leaves of seeded numpy params and gradients; the
new params agree within 1e-6 times max(1, |param|) (the same fp32
elementwise operations; the lr of a schedule computed in each framework).

LARC (clip and scale modes, with and without weight decay, over a FusedSGD
with momentum) gets one leaf whose gradient is 0 and one whose params are
0, so both zero-norm guards act beside ordinary leaves; the wrapped
optimizer's decay is restored after the step, a scaled gradient is
unscaled before the norms, and a warm-up schedule that starts at 0 stays
finite.  Three steps agree with the JAX LARC within 1e-6 relative.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.parallel import LARC as JaxLARC

from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import LARC

SHAPES = {"p0": (31, 13), "p1": (128,), "p2": (5, 7, 11)}
ITERS = 7
TOL = 1e-6


def _params():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(i):
    rng = np.random.default_rng(100 + i)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def jax_schedule(count):
    return 0.1 * jnp.minimum(count / 3.0, 1.0)


def torch_schedule(count):
    return 0.1 * torch.clamp(count / 3.0, max=1.0)


def _run(opt, params, steps, framework, scale=1.0, grads=_grads):
    if framework == "jax":
        p = {k: jnp.asarray(v) for k, v in params.items()}
        state = opt.init(p)
        for i in range(steps):
            g = {k: jnp.asarray(v * scale) for k, v in grads(i).items()}
            p, state = opt.step(state, g, p, scale=scale)
        return {k: np.asarray(v) for k, v in p.items()}, state
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(p)
    for i in range(steps):
        g = {k: torch.from_numpy(v * scale) for k, v in grads(i).items()}
        p, state = opt.step(state, g, p, scale=scale)
    return {k: v.numpy() for k, v in p.items()}, state


def _close(got, ref, tol=TOL):
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= tol * max(1.0, np.abs(ref[k]).max()), (k, err)


SGD_CASES = [
    (impl, dict(momentum=m, nesterov=n, weight_decay=wd))
    for impl in ("xla", "fused")
    for m, n, wd in [(0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 0.0),
                     (0.9, False, 1e-4)]
] + [
    ("xla", dict(momentum=0.9, dampening=0.1)),
    ("xla", dict(momentum=0.9, dampening=0.5, weight_decay=1e-3)),
    ("xla", dict(momentum=0.9, weight_decay=1e-3, wd_after_momentum=True)),
    ("fused", dict(momentum=0.9, weight_decay=1e-3, wd_after_momentum=True)),
    ("fused", dict(momentum=0.9, nesterov=True, scale=1024.0)),
    ("xla", dict(momentum=0.9, schedule=True)),
    ("fused", dict(momentum=0.5, schedule=True, weight_decay=1e-2)),
]


def _sgd_id(case):
    impl, kw = case
    return impl + "-" + "-".join(f"{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("case", SGD_CASES, ids=[_sgd_id(c) for c in
                                                 SGD_CASES])
def test_sgd_matches_jax(case):
    impl, kw = case
    kw = dict(kw)
    scale = kw.pop("scale", 1.0)
    schedule = kw.pop("schedule", False)
    j_opt = JaxSGD(lr=jax_schedule if schedule else 0.1, impl=impl, **kw)
    t_opt = FusedSGD(lr=torch_schedule if schedule else 0.1, impl=impl, **kw)
    ref, j_state = _run(j_opt, _params(), ITERS, "jax", scale)
    got, t_state = _run(t_opt, _params(), ITERS, "torch", scale)
    _close(got, ref)
    assert int(t_state.count) == int(j_state.count) == ITERS
    if impl == "fused":
        np.testing.assert_allclose(t_state.momentum.numpy(),
                                   np.asarray(j_state.momentum), rtol=1e-5,
                                   atol=1e-6)


def test_sgd_bad_options_raise():
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(lr=0.1, momentum=0.0, nesterov=True)
    opt = FusedSGD(lr=0.1, momentum=0.9, dampening=0.1, impl="fused")
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    with pytest.raises(NotImplementedError, match="dampening"):
        opt.step(state, {"w": torch.ones(4)}, p)


def _larc_params():
    p = _params()
    p["p1"] = np.zeros_like(p["p1"])            # a zero-norm param
    return p


def _larc_grads(i):
    g = _grads(i)
    g["p2"] = np.zeros_like(g["p2"])            # a zero-norm gradient
    return g


LARC_CASES = [
    ("clip", dict(clip=True), dict(weight_decay=0.0)),
    ("clip_wd", dict(clip=True), dict(weight_decay=1e-2)),
    ("scale", dict(clip=False, trust_coefficient=0.1), dict(weight_decay=0)),
    ("scale_wd", dict(clip=False), dict(weight_decay=5e-3)),
    ("clip_scaled_grads", dict(clip=True), dict(weight_decay=1e-2,
                                                scale=512.0)),
    ("clip_schedule", dict(clip=True), dict(weight_decay=1e-2,
                                            schedule=True)),
]


@pytest.mark.parametrize("case", LARC_CASES, ids=[c[0] for c in LARC_CASES])
def test_larc_matches_jax(case):
    _, larc_kw, sgd_kw = case
    sgd_kw = dict(sgd_kw)
    scale = sgd_kw.pop("scale", 1.0)
    schedule = sgd_kw.pop("schedule", False)
    j_opt = JaxLARC(JaxSGD(lr=jax_schedule if schedule else 0.1,
                           momentum=0.9, **sgd_kw), **larc_kw)
    t_opt = LARC(FusedSGD(lr=torch_schedule if schedule else 0.1,
                          momentum=0.9, **sgd_kw), **larc_kw)
    ref, _ = _run(j_opt, _larc_params(), 3, "jax", scale, _larc_grads)
    got, _ = _run(t_opt, _larc_params(), 3, "torch", scale, _larc_grads)
    _close(got, ref)
    assert all(np.isfinite(v).all() for v in got.values())
    # the zero-gradient leaf keeps its params (no decay leaks in), the
    # zero-norm leaf moves by the plain SGD step only
    np.testing.assert_array_equal(got["p2"], _larc_params()["p2"])
    assert t_opt.optim.weight_decay == sgd_kw["weight_decay"]
    assert t_opt.momentum == 0.9               # the wrapped optimizer's knob


def test_larc_clip_matches_reference_math():
    """One LARC + SGD step against the hand-computed update of the JAX
    package's test (||p|| = 5, ||g|| = 1)."""
    lr, tc, wd = 0.1, 0.02, 0.01
    opt = LARC(FusedSGD(lr=lr, weight_decay=wd), trust_coefficient=tc)
    p = {"w": torch.tensor([3.0, 4.0])}
    new_p, _ = opt.step(opt.init(p), {"w": torch.tensor([0.6, 0.8])}, p)
    adaptive = tc * 5.0 / (1.0 + 5.0 * wd + 1e-8)
    eff = (np.array([0.6, 0.8]) + wd * np.array([3.0, 4.0])) \
        * min(adaptive / lr, 1.0)
    np.testing.assert_allclose(new_p["w"].numpy(),
                               np.array([3.0, 4.0]) - lr * eff, rtol=1e-6)
