"""FusedLAMB of the PyTorch port against the JAX package.

One parameter tree (the transformer's, small) and one sequence of seeded
numpy gradients go to ``apex_tpu.optimizers.FusedLAMB`` and to the port's,
for five steps, with each impl ("xla": per-leaf tree math; "fused": the
flat engine, whose clip norm comes from the l2norm kernel's plain version
on the CPU).  Cases cover the global-norm clip biting (max_grad_norm below
the gradients' norm), weight decay 0 and 0.01, ``use_nvlamb`` and bf16
moment storage.  Master params agree to 1e-6 (fp32, reductions in other
orders).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.optimizers import FusedLAMB as JaxLAMB

from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

DIMS = dict(vocab_size=61, max_len=16, num_layers=2, d_model=32,
            num_heads=2, d_ff=64)
STEPS = 5

# name, impl, kwargs
CASES = [
    ("fused_clip", "fused", dict(weight_decay=0.01, max_grad_norm=1.0)),
    ("fused_noclip", "fused", dict(weight_decay=0.01, max_grad_norm=1e6)),
    ("fused_wd0", "fused", dict(weight_decay=0.0, max_grad_norm=1.0)),
    ("fused_nvlamb_wd0", "fused", dict(weight_decay=0.0, use_nvlamb=True)),
    ("fused_bf16_state", "fused", dict(state_dtype="bf16")),
    ("fused_l2_mode", "fused", dict(adam_w_mode=False, weight_decay=0.01)),
    ("xla_clip", "xla", dict(weight_decay=0.01, max_grad_norm=1.0)),
    ("xla_wd0", "xla", dict(weight_decay=0.0)),
    ("xla_nvlamb_wd0", "xla", dict(weight_decay=0.0, use_nvlamb=True)),
]


def _grads(tree, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.5).astype(np.float32),
        tree)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lamb_matches_jax(case):
    _, impl, kw = case
    jtree = jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(2), JaxConfig(**DIMS)))
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("state_dtype") == "bf16":
        jkw["state_dtype"], pkw["state_dtype"] = jnp.bfloat16, torch.bfloat16
    jopt = JaxLAMB(lr=1e-2, impl=impl, **jkw)
    popt = FusedLAMB(lr=1e-2, impl=impl, **pkw)
    jp = jax.tree_util.tree_map(jnp.asarray, jtree)
    pp = params_from_jax(jtree, device="cpu")
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(STEPS):
        g = _grads(jtree, step)
        jp, js = jopt.step(js, jax.tree_util.tree_map(jnp.asarray, g), jp)
        pp, ps = popt.step(ps, params_from_jax(g, device="cpu"), pp)
    assert int(ps.count) == STEPS
    for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    if impl == "fused":
        np.testing.assert_allclose(ps.master.numpy(), np.asarray(js.master),
                                   atol=1e-6, rtol=0)
        assert ps.m.dtype == (torch.bfloat16 if "state_dtype" in kw
                              else torch.float32)


def test_clip_bites():
    """With max_grad_norm far below the grads' norm, the clipped step
    differs from the unclipped one (the case above exercises the clip).
    The trust ratio undoes a uniform rescale, so the gradient varies and
    eps is large enough for the scale to show in the direction."""
    tree = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    grads = tree_map(lambda p: torch.arange(p.numel(), dtype=torch.float32)
                     .view(p.shape) * 3.0, tree)
    outs = []
    for mgn in (1e-3, 1e6):
        opt = FusedLAMB(lr=1e-2, impl="fused", max_grad_norm=mgn,
                        bias_correction=False, eps=1.0)
        p, _ = opt.step(opt.init(tree), grads, tree)
        outs.append(p["w"])
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("bad", ["impl", "state_dtype_xla", "amsgrad",
                                 "int_state"])
def test_bad_options_raise(bad):
    kw = {"impl": "fused"}
    if bad == "impl":
        kw["impl"] = "pallas"
    elif bad == "state_dtype_xla":
        kw = {"impl": "xla", "state_dtype": torch.bfloat16}
    elif bad == "amsgrad":
        kw["amsgrad"] = True
    else:
        kw["state_dtype"] = torch.int32
    with pytest.raises((ValueError, RuntimeError)):
        FusedLAMB(**kw)


def test_step_flat_shard_waits_for_the_distributed_slice():
    opt = FusedLAMB(impl="fused")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        opt.step_flat_shard(None, None, shard=None)
