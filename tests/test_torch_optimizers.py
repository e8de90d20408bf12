"""FusedLAMB of the PyTorch port against the JAX package.

One parameter tree (the transformer's, small) and one sequence of seeded
numpy gradients go to ``apex_tpu.optimizers.FusedLAMB`` and to the port's,
for five steps, with each impl ("xla": per-leaf tree math; "fused": the
flat engine, whose clip norm comes from the l2norm kernel's plain version
on the CPU).  Cases cover the global-norm clip biting (max_grad_norm below
the gradients' norm), weight decay 0 and 0.01, ``use_nvlamb`` and bf16
moment storage.  Master params agree to 1e-6 (fp32, reductions in other
orders).

FusedAdam goes the same way, both impls: AdamW and classic L2 decay,
``bias_correction=False``, a ``model_dtype`` (bf16 params out), bf16
moment storage and a learning-rate schedule.  Params and the flat master
agree to 1e-6 (fp32 elementwise math; bias corrections from fp32 ``pow``
in each framework), a bf16 model copy to one bf16 step (2^-8 relative).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.optimizers import FusedLAMB as JaxLAMB

from apex_tpu_torch.models import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, adam_state_from_jax
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


def test_step_flat_shard_waits_for_the_distributed_slice(tmp_path):
    """The sharded LAMB update (weight-update sharding) over a world-1
    shard is ``step_flat``'s bits; an optimizer with per-tensor
    reductions and no sharded form refuses."""
    import _torch_dist
    from apex_tpu_torch.optimizers import FusedOptimizer
    from apex_tpu_torch.parallel.weight_update import ShardContext

    def run(rank, world):
        rng = np.random.default_rng(3)
        params = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(
            np.float32)), "b": torch.from_numpy(rng.standard_normal(
                300).astype(np.float32))}
        grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in params.items()}
        opt = FusedLAMB(impl="fused", lr=1e-2)
        st = opt.init(params)
        g = opt.flattener.flatten(grads)
        whole = opt.step_flat(st, g)
        shard = opt.step_flat_shard(
            st, g, shard=ShardContext(None, opt.flattener, 1))
        return all(torch.equal(a, b) for a, b in zip(whole, shard))

    assert _torch_dist.run_in_process(run, tmp_path)
    assert not FusedLAMB.elementwise_flat_update

    class Coupled(FusedOptimizer):
        elementwise_flat_update = False
    with pytest.raises(NotImplementedError, match="step_flat_shard"):
        Coupled(1e-3, impl="fused").step_flat_shard(None, None, shard=None)


# name, impl, kwargs
ADAM_CASES = [
    ("fused_adamw", "fused", dict(weight_decay=0.01)),
    ("fused_l2_mode", "fused", dict(adam_w_mode=False, weight_decay=0.01)),
    ("fused_no_bias_correction", "fused", dict(bias_correction=False)),
    ("fused_bf16_state", "fused", dict(state_dtype="bf16")),
    ("fused_bf16_model", "fused", dict(model_dtype="bf16",
                                        weight_decay=0.01)),
    ("fused_schedule", "fused", dict(lr="schedule")),
    ("xla_adamw", "xla", dict(weight_decay=0.01)),
    ("xla_l2_mode", "xla", dict(adam_w_mode=False, weight_decay=0.01)),
    ("xla_bf16_model", "xla", dict(model_dtype="bf16")),
    ("xla_schedule", "xla", dict(lr="schedule", bias_correction=False)),
]


def _adam_kwargs(kw, framework):
    out = dict(kw)
    bf16 = jnp.bfloat16 if framework == "jax" else torch.bfloat16
    for key in ("state_dtype", "model_dtype"):
        if out.get(key) == "bf16":
            out[key] = bf16
    if out.get("lr") == "schedule":
        # the step count is a device integer in both frameworks
        out["lr"] = lambda count: 1e-2 * 0.5 ** count
    else:
        out["lr"] = 1e-2
    return out


@pytest.mark.parametrize("case", ADAM_CASES, ids=[c[0] for c in ADAM_CASES])
def test_adam_matches_jax(case):
    _, impl, kw = case
    jtree = jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(4), JaxConfig(**DIMS)))
    jopt = JaxAdam(impl=impl, **_adam_kwargs(kw, "jax"))
    popt = FusedAdam(impl=impl, **_adam_kwargs(kw, "torch"))
    jp = jax.tree_util.tree_map(jnp.asarray, jtree)
    pp = params_from_jax(jtree, device="cpu")
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(STEPS):
        g = _grads(jtree, step)
        # amp-style scale on the fused path, 1 on the tree path
        scale = 8.0 if impl == "fused" else 1.0
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a * scale), g)
        pg = params_from_jax(jax.tree_util.tree_map(lambda a: a * scale, g),
                             device="cpu")
        jnew, js = jopt.step(js, jg, jp, scale=scale)
        pnew, ps = popt.step(ps, pg, pp, scale=scale)
        if "model_dtype" not in kw:
            jp, pp = jnew, pnew
    assert int(ps.count) == STEPS
    bf16_model = "model_dtype" in kw
    for a, b in zip(tree_leaves(pnew), jax.tree_util.tree_leaves(jnew)):
        assert a.dtype == (torch.bfloat16 if bf16_model else torch.float32)
        ref = np.asarray(b.astype(jnp.float32))
        if bf16_model:
            np.testing.assert_allclose(a.float().numpy(), ref,
                                       rtol=2.0 ** -8, atol=1e-6)
        else:
            np.testing.assert_allclose(a.numpy(), ref, atol=1e-6, rtol=0)
    if impl == "fused":
        np.testing.assert_allclose(ps.master.numpy(), np.asarray(js.master),
                                   atol=1e-6, rtol=0)
        assert ps.m.dtype == (torch.bfloat16 if "state_dtype" in kw
                              else torch.float32)
        state = adam_state_from_jax(
            jax.tree_util.tree_map(np.asarray, js), device="cpu")
        assert state.m.dtype == ps.m.dtype and int(state.count) == STEPS
        for a, b in zip(state, ps):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=1e-6, rtol=0)


def test_adam_tree_state_from_jax_and_bad_options():
    jtree = {"w": np.ones((3, 4), np.float32), "b": np.zeros(4, np.float32)}
    js = JaxAdam(impl="xla").init(jax.tree_util.tree_map(jnp.asarray, jtree))
    st = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                             device="cpu")
    assert st.master is None and st.count.dtype == torch.int32
    assert st.m["w"].shape == (3, 4) and st.v["b"].dtype == torch.float32
    with pytest.raises(RuntimeError):
        FusedAdam(amsgrad=True)
    with pytest.raises(ValueError):
        FusedAdam(impl="xla", state_dtype=torch.bfloat16)
