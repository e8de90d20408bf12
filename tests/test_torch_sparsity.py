"""ASP 2:4 sparsity of the PyTorch port against the JAX package (the
counterpart of ``tests/L0/test_sparsity.py``).

The same numpy weights go to ``apex_tpu.contrib.sparsity`` and to
``apex_tpu_torch.contrib.sparsity``.  Masks must be the JAX package's bit
for bit, ties included (a pattern's score is a sum of two fp32 values,
rounded once in both packages; the first best pattern wins in both), and
the eligible-path sets equal.  ``SparseOptimizer.step`` (per-leaf) and
``step_flat`` (the flat engine) over FusedAdam and FusedLAMB hold params to
the JAX package's for 3 steps at 1e-6 relative (fp32 elementwise math,
reductions in other orders), and keep every pruned leaf 2:4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.sparsity import ASP as JaxASP
from apex_tpu.contrib.sparsity import create_mask as jax_create_mask
from apex_tpu.contrib.sparsity import mn_1d_best as jax_mn_1d_best
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.optimizers import FusedLAMB as JaxLAMB

from apex_tpu_torch import checkpoint
from apex_tpu_torch.contrib.sparsity import (ASP, SparseOptimizer,
                                             create_mask, m4n2_1d,
                                             mn_1d_best)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.utils.device import from_numpy
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map


def brute_force_best_mask_row(row):
    """Oracle: per group of 4, keep the 2 largest |values|."""
    out = np.zeros_like(row)
    for g in range(0, len(row), 4):
        keep = np.argsort(-np.abs(row[g:g + 4]), kind="stable")[:2]
        out[g + keep] = 1.0
    return out


def _ties(shape, seed):
    """Weights drawn from four magnitudes with random signs: most groups
    of 4 hold ties among their largest values."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.float32([0.5, 1.0, 1.0, 2.0]), size=shape)
    return (vals * rng.choice(np.float32([-1, 1]), size=shape)
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["randn", "ties", "bf16_ties"])
def test_mn_1d_best_matches_bruteforce_and_jax(kind):
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((6, 16)).astype(np.float32) \
        if kind == "randn" else _ties((6, 16), 1)
    if kind == "bf16_ties":
        # bf16 weights: 8 bits of mantissa make ties common
        mat = (rng.standard_normal((6, 16)) * 0.01).astype(np.float32)
        jm = jnp.asarray(mat).astype(jnp.bfloat16)
        tm = torch.from_numpy(mat).bfloat16()
    else:
        jm, tm = jnp.asarray(mat), torch.from_numpy(mat)
    got = mn_1d_best(tm, 4, 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_mn_1d_best(jm, 4, 2)))
    if kind == "randn":
        for i in range(mat.shape[0]):
            np.testing.assert_array_equal(got[i],
                                          brute_force_best_mask_row(mat[i]))
    assert (got.reshape(6, 4, 4).sum(-1) == 2).all()


def test_mask_density_and_axis():
    w = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    for axis in (-1, -2, 0):
        got = create_mask(torch.from_numpy(w), axis=axis)
        ref = jax_create_mask(jnp.asarray(w), axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert float(got.mean()) == 0.5
    gc = create_mask(torch.from_numpy(w), axis=-2).numpy().reshape(
        2, 4, 16).sum(axis=1)
    assert (gc == 2).all()
    # 3-D and 1-D leaves, and a bf16 leaf's mask in bf16
    w3 = _ties((3, 8, 16), 2)
    np.testing.assert_array_equal(
        create_mask(torch.from_numpy(w3)).numpy(),
        np.asarray(jax_create_mask(jnp.asarray(w3))))
    w1 = w[0]
    np.testing.assert_array_equal(
        create_mask(torch.from_numpy(w1)).numpy(),
        np.asarray(jax_create_mask(jnp.asarray(w1))))
    mb = create_mask(torch.from_numpy(w3).bfloat16())
    assert mb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mb.float().numpy(),
        np.asarray(jax_create_mask(jnp.asarray(w3).astype(jnp.bfloat16)),
                   np.float32))


def test_create_mask_ragged_pads_prefer_masking_and_rules():
    w = np.arange(1, 7, dtype=np.float32).reshape(1, 6)
    m = create_mask(torch.from_numpy(w), axis=-1).numpy()
    np.testing.assert_array_equal(
        m, np.asarray(jax_create_mask(jnp.asarray(w), axis=-1)))
    assert m[0, 4] == 1 and m[0, 5] == 1 and m.sum() == 4
    t = torch.ones(4, 8)
    with pytest.raises(ValueError, match="fixed density"):
        create_mask(t, density=0.25)
    with pytest.raises(ValueError, match="unknown sparsity pattern"):
        create_mask(t, pattern="m8n4")
    with pytest.raises(ValueError, match="scalar"):
        create_mask(torch.ones(()))
    # a callable pattern, as the JAX package takes it
    np.testing.assert_array_equal(
        create_mask(t, pattern=m4n2_1d).numpy(),
        np.asarray(jax_create_mask(jnp.ones((4, 8)), pattern=lambda a, d:
                                   jax_mn_1d_best(a, 4, 2))))


def _toy_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "fc1": {"w": rng.standard_normal((16, 32)).astype(np.float32),
                "b": np.zeros(32, np.float32)},
        "fc2": {"w": rng.standard_normal((32, 8)).astype(np.float32),
                "b": np.zeros(8, np.float32)},
        "tiny": rng.standard_normal((3, 5)).astype(np.float32),
    }


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("policy", [
    {}, {"disallowed_layer_names": ("fc2",)},
    {"allowed_layer_names": ("fc2",)}, {"axis": -1}])
def test_eligibility_rules(policy):
    jp, tp = _both(_toy_np())
    jelig = JaxASP(**policy).init_model_for_pruning(jp)._eligible_paths
    telig = ASP(**policy).init_model_for_pruning(tp)._eligible_paths
    assert telig == jelig
    if not policy:
        assert telig == frozenset({"fc1/w", "fc2/w"})


def test_requires_init_ordering():
    asp = ASP()
    _, tp = _both(_toy_np())
    with pytest.raises(RuntimeError, match="init_model_for_pruning"):
        asp.compute_sparse_masks(tp)
    with pytest.raises(RuntimeError):
        asp.wrap_optimizer(FusedAdam(), {})


def _grads(tree, step):
    rng = np.random.default_rng(10 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.5).astype(np.float32),
        tree)


def _two_four(w, axis=-2):
    """Every aligned group of 4 along ``axis`` has at most 2 nonzeros."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    return bool(((w.reshape(-1, 4) != 0).sum(-1) <= 2).all())


@pytest.mark.parametrize("opt,impl", [("adam", "xla"), ("adam", "fused"),
                                      ("lamb", "xla"), ("lamb", "fused")])
def test_wrapped_optimizer_matches_jax_and_keeps_sparsity(opt, impl):
    """step over the tree (xla) and, for the fused impl, step_flat over
    the flat engine, 3 steps each, against the JAX package's."""
    np_params = _toy_np()
    jp, tp = _both(np_params)
    jasp = JaxASP().init_model_for_pruning(jp)
    tasp = ASP().init_model_for_pruning(tp)
    jmasks, tmasks = jasp.compute_sparse_masks(jp), \
        tasp.compute_sparse_masks(tp)
    for a, b in zip(tree_leaves(tmasks), jax.tree_util.tree_leaves(jmasks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jp, tp = jasp.prune(jp, jmasks), tasp.prune(tp, tmasks)
    kw = dict(lr=1e-2, weight_decay=0.01, impl=impl)
    if opt == "adam":
        jopt, topt = JaxAdam(**kw), FusedAdam(**kw)
    else:
        jopt, topt = JaxLAMB(max_grad_norm=1.0, **kw), \
            FusedLAMB(max_grad_norm=1.0, **kw)
    jw, tw = jasp.wrap_optimizer(jopt, jmasks), tasp.wrap_optimizer(topt,
                                                                    tmasks)
    assert isinstance(tw, SparseOptimizer) and tw.impl == impl
    js, ts = jw.init(jp), tw.init(tp)
    for step in range(3):
        g = _grads(np_params, step)
        jg, tg = _both(g)
        jp, js = jw.step(js, jg, jp)
        tp, ts = tw.step(ts, tg, tp)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert _two_four(tp["fc1"]["w"]) and _two_four(tp["fc2"]["w"])
    assert float(tp["fc1"]["b"].abs().sum()) > 0     # ineligible: trained
    if impl == "fused":
        np.testing.assert_allclose(ts.master.numpy(), np.asarray(js.master),
                                   rtol=1e-6, atol=1e-6)
        # the flat path: step_flat on flat gradients, the master masked
        fl_j, fl_t = jopt.flattener, topt.flattener
        for step in range(3, 6):
            g = _grads(np_params, step)
            jg, tg = _both(g)
            js = jw.step_flat(js, fl_j.flatten(jg))
            ts = tw.step_flat(ts, fl_t.flatten(tg))
        np.testing.assert_allclose(ts.master.numpy(), np.asarray(js.master),
                                   rtol=1e-6, atol=1e-6)
        flat_mask = fl_t.flatten(tmasks)
        assert set(np.unique(flat_mask.numpy())) <= {0.0, 1.0}
        assert bool((ts.master[flat_mask == 0] == 0).all())
        unflat = fl_t.unflatten(ts.master)
        assert _two_four(unflat["fc1"]["w"]) and _two_four(unflat["fc2"]["w"])


def test_update_is_the_masked_step():
    np_params = _toy_np(3)
    _, tp = _both(np_params)
    asp = ASP().init_model_for_pruning(tp)
    masks = asp.compute_sparse_masks(tp)
    tp = asp.prune(tp, masks)
    opt = asp.wrap_optimizer(FusedAdam(lr=1e-2), masks)
    st = opt.init(tp)
    _, tg = _both(_grads(np_params, 0))
    upd, _ = opt.update(tg, st, tp)
    new, _ = opt.step(st, tg, tp)
    for u, n, p in zip(tree_leaves(upd), tree_leaves(new), tree_leaves(tp)):
        assert torch.equal(u, n - p)


def test_checkpoint_continuity(tmp_path):
    """Train, save, load, recompute the masks: they equal the first ones
    (a pruned weight's mask recomputes to itself), and training goes on
    2:4 (the reference's checkpointing_test_part1 / part2 flow)."""
    np_params = _toy_np()
    _, tp = _both(np_params)
    asp = ASP().init_model_for_pruning(tp)
    masks = asp.compute_sparse_masks(tp)
    tp = asp.prune(tp, masks)
    opt = asp.wrap_optimizer(FusedAdam(lr=1e-2), masks)
    st = opt.init(tp)
    for step in range(2):
        tp, st = opt.step(st, tree_map(lambda x: 0.1 * torch.ones_like(x),
                                       tp), tp)
    path = tmp_path / "asp_ckpt.pkl"
    checkpoint.save(str(path), params=tp)
    loaded = checkpoint.restore_like(tp, checkpoint.load(str(path))["params"])
    asp2 = ASP().init_model_for_pruning(loaded)
    masks2 = asp2.compute_sparse_masks(loaded)
    for a, b in zip(tree_leaves(masks), tree_leaves(masks2)):
        assert torch.equal(a, b)
    opt2 = asp2.wrap_optimizer(FusedAdam(lr=1e-2), masks2)
    p2, _ = opt2.step(opt2.init(loaded), tree_map(
        lambda x: 0.1 * torch.ones_like(x), loaded), loaded)
    assert _two_four(p2["fc1"]["w"]) and _two_four(p2["fc2"]["w"])


def test_masks_carry_no_graph():
    """Masks of leaves that require a gradient are plain 0/1 tensors with
    no autograd history (the JAX test's jit- and grad-safety)."""
    _, tp = _both(_toy_np())
    tp = tree_map(lambda x: x.requires_grad_(True), tp)
    masks = ASP().init_model_for_pruning(tp).compute_sparse_masks(tp)
    m = masks["fc1"]["w"]
    assert not m.requires_grad and m.grad_fn is None
    assert float(m.mean()) == 0.5
