"""The deprecated contrib optimizers of the PyTorch port: each facade
warns (``DeprecationWarning`` naming its replacement), steps exactly as the
port's modern optimizer it wraps (the same math, so the same bits), and
matches the JAX package's facade within 1e-6 over a few steps, the
deprecated Adam's clip folded into its scale included."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.optimizers import deprecated as jdep

from apex_tpu_torch.contrib.optimizers import deprecated
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
from apex_tpu_torch.utils.pytree import tree_leaves

STEPS = 4


def _tree():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((6, 8)) * 0.5).astype(np.float32),
            "b": (rng.standard_normal(8) * 0.1).astype(np.float32)}


def _grads(step, scale=1.0):
    rng = np.random.default_rng(10 + step)
    return {"w": (rng.standard_normal((6, 8)) * scale).astype(np.float32),
            "b": (rng.standard_normal(8) * scale).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# name, facade kwargs, the modern optimizer it should equal (None: the
# facade's clip has no modern twin; the JAX facade is the reference)
CASES = [
    ("FusedAdam", dict(lr=1e-2, weight_decay=0.01),
     lambda: FusedAdam(lr=1e-2, weight_decay=0.01, adam_w_mode=False)),
    ("FusedAdam", dict(lr=1e-2, max_grad_norm=1.0), None),
    ("FusedLAMB", dict(lr=1e-2), lambda: FusedLAMB(lr=1e-2)),
    ("FusedSGD", dict(lr=0.1, momentum=0.9, nesterov=True),
     lambda: FusedSGD(lr=0.1, momentum=0.9, nesterov=True)),
]


@pytest.mark.parametrize("name,kw,modern", CASES,
                         ids=["adam", "adam_clip", "lamb", "sgd"])
def test_facade_warns_and_matches_modern_and_jax(name, kw, modern):
    tree = _tree()
    with pytest.warns(DeprecationWarning, match=f"optimizers.{name}"):
        opt = getattr(deprecated, name)(_t(tree), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jopt = getattr(jdep, name)(
            {k: jnp.asarray(v) for k, v in tree.items()}, **kw)
    ref = modern() if modern is not None else None
    if ref is not None:
        rp = _t(tree)
        rs = ref.init(rp)
    for step in range(STEPS):
        g = _grads(step, 8.0)
        out = opt.step(grads=_t(g), scale=8.0)
        jout = jopt.step(grads={k: jnp.asarray(v) for k, v in g.items()},
                         scale=8.0)
        if ref is not None:
            rp, rs = ref.step(rs, _t(g), rp, scale=8.0)
            for a, b in zip(tree_leaves(out), tree_leaves(rp)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in tree:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-6)
    assert opt.params is out


def test_output_params_dtype_and_state_dict():
    with pytest.warns(DeprecationWarning):
        opt = deprecated.FusedSGD(_t(_tree()), lr=0.1)
    out = opt.step(grads=_t(_grads(0)), output_params=torch.float16)
    assert all(v.dtype == torch.float16 for v in out.values())
    out = opt.step(grads=_t(_grads(1)), output_params=torch.zeros(1,
                   dtype=torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    blob = opt.state_dict()
    with pytest.warns(DeprecationWarning):
        opt2 = deprecated.FusedSGD(_t(_tree()), lr=0.1)
    opt2.load_state_dict(blob)
    a = opt.step(grads=_t(_grads(2)))
    b = opt2.step(grads=_t(_grads(2)))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_facade_refusals():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="AMSGrad"):
            deprecated.FusedAdam(_t(_tree()), amsgrad=True)
        with pytest.raises(NotImplementedError, match="eps_inside_sqrt"):
            deprecated.FusedAdam(_t(_tree()), eps_inside_sqrt=True)
        with pytest.raises(RuntimeError, match="AMSGrad"):
            deprecated.FusedLAMB(_t(_tree()), amsgrad=True)
        opt = deprecated.FusedSGD(_t(_tree()), lr=0.1)
    with pytest.raises(ValueError, match="grads"):
        opt.step()
    with pytest.raises(NotImplementedError, match="grad_norms"):
        opt.step(grads=_t(_grads(0)), grad_norms=[1.0])


def test_contrib_optimizers_exports_deprecated():
    import apex_tpu_torch.contrib.optimizers as c
    assert c.deprecated is deprecated
