"""amp of the PyTorch port against the JAX package.

For each opt level, ``initialize`` on the same fp32 parameter tree gives
the same model and master dtypes, loss scale and flat-master detection in
both packages; at O1 and O4 both turn on their per-op casts (fp16 and
bf16 products), and ``uninit`` turns them off (the op table itself is
``tests/test_torch_amp_autocast.py``).  With dynamic loss scaling, a step
whose gradients hold an inf is skipped and the scale halves, as in the JAX
package; finite steps match its scale and masters.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.overrides import _get_current_function_mode_stack

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedLAMB as JaxLAMB

from apex_tpu_torch import amp
from apex_tpu_torch.contrib.multihead_attn import flash as pflash
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.utils.pytree import tree_leaves

_JDT = {jnp.dtype(jnp.float32): torch.float32,
        jnp.dtype(jnp.float16): torch.float16,
        jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _tree():
    rng = np.random.default_rng(0)
    return {"dense": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                      "b": np.zeros(16, np.float32)},
            "layer_norm": {"scale": np.ones(16, np.float32)},
            "ln_g": np.ones(16, np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("level", ["O0", "O2", "O3", "O5"])
def test_initialize_matches_jax(level, impl):
    tree = _tree()
    js = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, tree),
                         JaxLAMB(impl=impl), opt_level=level, verbosity=0)
    ps = amp.initialize(_torch_tree(tree), FusedLAMB(impl=impl),
                        opt_level=level, verbosity=0)
    j_model = jax.tree_util.tree_leaves(js.model_params)
    p_model = tree_leaves(ps.model_params)
    assert [_JDT[jnp.dtype(l.dtype)] for l in j_model] == \
        [l.dtype for l in p_model]
    assert (js.master_params is None) == (ps.master_params is None)
    if ps.master_params is not None:
        assert all(l.dtype == torch.float32
                   for l in tree_leaves(ps.master_params))
    assert float(js.loss_scale) == float(ps.loss_scale)
    assert js.scalers[0].dynamic == ps.scalers[0].dynamic
    assert jamp.frontend._flat_masters_active(js) == \
        amp.frontend._flat_masters_active(ps)
    for a, b in zip(tree_leaves(ps.params_for_eval()),
                    jax.tree_util.tree_leaves(js.params_for_eval())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_o5_casts_the_transformer_norm_leaves():
    """The norm leaves' names (ln_g, ...) miss the norm pattern, so O5
    casts them to bf16 too; a path named layer_norm stays fp32."""
    ps = amp.initialize(_torch_tree(_tree()), FusedLAMB(impl="fused"),
                        opt_level="O5", verbosity=0)
    assert ps.model_params["ln_g"].dtype == torch.bfloat16
    assert ps.model_params["layer_norm"]["scale"].dtype == torch.float32
    assert ps.model_params["dense"]["w"].dtype == torch.bfloat16
    assert float(ps.loss_scale) == 1.0 and not ps.scalers[0].dynamic


def test_bad_opt_level_raises():
    with pytest.raises(RuntimeError, match="O0'..'O5"):
        amp.initialize(_torch_tree(_tree()), None, opt_level="O7",
                       verbosity=0)


@pytest.mark.parametrize("level", ["O1", "O4"])
def test_patching_levels_turn_on_casts(level):
    """O1 / O4 (which once raised here): ``initialize`` leaves the model
    fp32, keeps the JAX package's loss scale, and turns on the casts of
    the level's low-precision type, as the JAX package's does; ``uninit``
    turns them off and leaves no torch function mode behind."""
    want_t = {"O1": torch.float16, "O4": torch.bfloat16}[level]
    want_j = {"O1": jnp.float16, "O4": jnp.bfloat16}[level]
    tree = _tree()
    try:
        js = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, tree),
                             JaxLAMB(impl="xla"), opt_level=level,
                             verbosity=0)
        ps = amp.initialize(_torch_tree(tree), FusedLAMB(impl="xla"),
                            opt_level=level, verbosity=0)
        assert all(l.dtype == torch.float32
                   for l in tree_leaves(ps.model_params))
        assert ps.master_params is None and js.master_params is None
        assert float(js.loss_scale) == float(ps.loss_scale)
        assert js.scalers[0].dynamic == ps.scalers[0].dynamic
        assert amp.is_initialized()
        w = ps.model_params["dense"]["w"]
        assert torch.matmul(torch.ones(2, 8), w).dtype == want_t
        assert jnp.matmul(jnp.ones((2, 8)),
                          js.model_params["dense"]["w"]).dtype == want_j
        assert torch.sum(torch.ones(3, dtype=want_t)).dtype == torch.float32
    finally:
        amp.uninit()
    assert not amp.is_initialized()
    assert not _get_current_function_mode_stack()
    assert torch.matmul(torch.ones(2, 8), w).dtype == torch.float32


def test_non_fp32_params_raise():
    tree = _torch_tree(_tree())
    tree["dense"]["w"] = tree["dense"]["w"].half()
    with pytest.raises(RuntimeError, match="not fp32"):
        amp.initialize(tree, None, opt_level="O5", verbosity=0)
    st = amp.initialize(tree, None, opt_level="O5", verbosity=0,
                        allow_incoming_model_not_fp32=True)
    assert st.model_params["dense"]["w"].dtype == torch.bfloat16


def test_flash_attn_backward_sets_the_flash_default():
    try:
        amp.initialize(_torch_tree(_tree()), None, opt_level="O5",
                       verbosity=0, flash_attn_backward="xla")
        assert pflash._resolve_backward("auto") == "xla"
        with pytest.raises(ValueError):
            amp.initialize(_torch_tree(_tree()), None, opt_level="O5",
                           verbosity=0, flash_attn_backward="cuda")
    finally:
        pflash.set_default_backward("auto")


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_dynamic_scale_skips_inf_steps_like_jax(impl):
    tree = _tree()
    js = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, tree),
                         JaxLAMB(lr=1e-2, impl=impl), opt_level="O0",
                         loss_scale="dynamic", verbosity=0)
    ps = amp.initialize(_torch_tree(tree), FusedLAMB(lr=1e-2, impl=impl),
                        opt_level="O0", loss_scale="dynamic", verbosity=0)
    rng = np.random.default_rng(5)
    for step in range(4):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 1e3).astype(np.float32),
            tree)
        if step in (1, 2):
            g["dense"]["w"][0, 0] = np.inf
        before = [l.clone() for l in tree_leaves(ps.params_for_eval())]
        js = jamp.amp_step(js, jax.tree_util.tree_map(jnp.asarray, g))
        ps = amp.amp_step(ps, _torch_tree(g))
        assert float(ps.loss_scale) == float(js.loss_scale)
        after = tree_leaves(ps.params_for_eval())
        if step in (1, 2):           # skipped: masters unchanged
            for a, b in zip(after, before):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(after, jax.tree_util.tree_leaves(
                js.params_for_eval())):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert float(ps.loss_scale) == 2.0 ** 14      # halved twice
    assert len(amp.master_params(ps)) == 4


def test_scale_loss_and_step_without_optimizer_raises():
    ps = amp.initialize(_torch_tree(_tree()), None, opt_level="O2",
                        verbosity=0)
    assert float(amp.scale_loss(torch.tensor(2.0), ps)) == 2.0 * 2 ** 16
    with pytest.raises(RuntimeError, match="optimizer"):
        amp.amp_step(ps, ps.model_params)


# ---------------------------------------------------------------------------
# the scaler, properties and pytree names the port had lacked
# ---------------------------------------------------------------------------

def _grads(seed, inf=False):
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float16)}
    if inf:
        g["b"][2] = np.inf
    return g


@pytest.mark.parametrize("check_finite", [True, False])
@pytest.mark.parametrize("inf", [False, True])
def test_unscale_matches_jax(check_finite, inf):
    from apex_tpu.amp import scaler as jscaler
    from apex_tpu_torch.amp import scaler
    g = _grads(1, inf)
    js = jscaler.init(init_scale=512.0)
    ps = scaler.init(init_scale=512.0, device="cpu")
    jout, jfin = jscaler.unscale(js, jax.tree_util.tree_map(jnp.asarray, g),
                                 check_finite=check_finite)
    pout, pfin = scaler.unscale(ps, _torch_tree(g),
                                check_finite=check_finite)
    assert bool(pfin) == bool(jfin) == (not (inf and check_finite))
    for k in g:
        assert pout[k].dtype == torch.float32
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))


@pytest.mark.parametrize("inf", [False, True])
def test_unscale_with_stashed_matches_jax(inf):
    from apex_tpu.amp import scaler as jscaler
    from apex_tpu_torch.amp import scaler
    new, stashed = _grads(2, inf), _grads(3)
    js = jscaler.init(init_scale=1024.0)
    ps = scaler.init(init_scale=1024.0, device="cpu")
    jout, jfin = jscaler.unscale_with_stashed(
        js, jax.tree_util.tree_map(jnp.asarray, new),
        jax.tree_util.tree_map(jnp.asarray, stashed))
    pout, pfin = scaler.unscale_with_stashed(ps, _torch_tree(new),
                                             _torch_tree(stashed))
    assert bool(pfin) == bool(jfin) == (not inf)
    for k in new:
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))


def test_transition_kind_matches_jax_on_a_grid():
    """Every branch: halved, doubled, a reset pinned at the floor (and at
    floor and ceiling at once), a reset at window - 1 (the clamped grow),
    an earlier reset, a reset with no bounds known, no change."""
    import itertools
    from apex_tpu.amp import scaler as jscaler
    from apex_tpu_torch.amp import scaler
    seen = set()
    for prev, new, pu, nu, window, lo, hi in itertools.product(
            (1.0, 2.0, 4.0), (1.0, 2.0, 4.0), (0, 1, 2), (0, 1, 3),
            (None, 2, 3), (None, 1.0, 2.0), (None, 2.0, 4.0)):
        args = (prev, new, pu, nu, window, lo, hi)
        got = scaler.transition_kind(*args)
        assert got == jscaler.transition_kind(*args), args
        seen.add(got)
    assert seen == {"overflow", "grew", "steady"}
    tk = scaler.transition_kind
    assert tk(4.0, 2.0, 5, 0) == "overflow"
    assert tk(2.0, 4.0, 1, 0) == "grew"
    assert tk(1.0, 1.0, 3, 0, 2000, 1.0, 2.0 ** 24) == "overflow"
    assert tk(1.0, 1.0, 3, 0, 4, 1.0, 1.0) == "steady"
    assert tk(8.0, 8.0, 1999, 0, 2000, 1.0, 8.0) == "steady"
    assert tk(8.0, 8.0, 5, 0, 2000, 1.0, 8.0) == "overflow"
    assert tk(8.0, 8.0, 5, 0) == "overflow"
    assert tk(8.0, 8.0, 5, 6) == "steady"


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4", "O5"])
def test_preset_classes_match_jax_and_opt_levels(level):
    """``properties.O<n>()(Properties())`` gives the JAX class's options
    (dtypes mapped), today's ``opt_levels`` entry and the table the port
    built before the classes existed."""
    from apex_tpu.amp import properties as jprops
    from apex_tpu_torch.amp import properties as props
    before = {
        "O0": ("O0", torch.float32, False, None, None, False, 1.0),
        "O1": ("O1", None, True, torch.float16, None, None, "dynamic"),
        "O2": ("O2", torch.float16, False, None, True, True, "dynamic"),
        "O3": ("O3", torch.float16, False, None, False, False, 1.0),
        "O4": ("O4", None, True, torch.bfloat16, None, None, 1.0),
        "O5": ("O5", torch.bfloat16, False, None, True, True, 1.0)}[level]
    keys = ("opt_level", "cast_model_type", "patch_functions",
            "patch_functions_type", "keep_batchnorm_fp32", "master_weights",
            "loss_scale")
    cls = getattr(props, level)
    got = cls()(props.Properties()).options
    assert isinstance(props.opt_levels[level], cls)
    assert props.opt_levels[level](props.Properties()).options == got
    assert tuple(got[k] for k in keys) == before and got["enabled"] is True
    j = getattr(jprops, level)()(jprops.Properties()).options
    assert set(j) == set(got)
    for k, v in j.items():
        assert (_JDT[v] if isinstance(v, jnp.dtype) else v) == got[k], k
    assert cls.brief.startswith(level + ":")


def test_tree_cast_like_casts_float_leaves_only():
    from apex_tpu.utils import pytree as jpt
    from apex_tpu_torch.utils.pytree import tree_cast_like
    src = {"a": np.linspace(-2, 2, 6, dtype=np.float32).reshape(2, 3),
           "b": np.arange(4, dtype=np.int32), "c": np.ones(3, np.float32)}
    like = {"a": np.zeros((2, 3), np.float16), "b": np.zeros(4, np.float32),
            "c": np.zeros(3, np.int32)}
    j = jpt.tree_cast_like(jax.tree_util.tree_map(jnp.asarray, src),
                           jax.tree_util.tree_map(jnp.asarray, like))
    t = tree_cast_like(_torch_tree(src), _torch_tree(like))
    for k in src:
        assert t[k].numpy().dtype == np.asarray(j[k]).dtype, k
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    assert t["a"].dtype == torch.float16 and t["b"].dtype == torch.float32
    assert t["c"].dtype == torch.float32
