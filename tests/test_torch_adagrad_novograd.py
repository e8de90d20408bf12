"""FusedAdagrad and FusedNovoGrad of the PyTorch port against the JAX
package.

One parameter tree and one sequence of seeded numpy gradients go to
``apex_tpu.optimizers`` and to the port for five steps, each impl ("xla":
per-leaf tree math; "fused": the flat engine, NovoGrad's per-tensor norms
from the flattener's row-range reductions), over each knob.  Params and
states agree within 1e-6 relative (``|port - jax| <= 1e-6 * max(1,
|jax|)``: the same fp32 elementwise math, reductions in other orders).
Adagrad is also held to ``torch.optim.Adagrad``; both run under amp's flat
fast path (O2 / O5, as ``tests/L0/test_amp_fused_flat.py``), and their
states cross between the packages through checkpoint files both ways and
through ``*_state_from_jax``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu import checkpoint as jckpt
from apex_tpu.optimizers import FusedAdagrad as JAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JNovoGrad
from apex_tpu.optimizers.fused_adagrad import FusedAdagradState as JAdaState
from apex_tpu.optimizers.fused_novograd import \
    FusedNovoGradState as JNovoState

from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.optimizers import (
    FusedAdagrad, FusedAdagradState, FusedNovoGrad, FusedNovoGradState,
    adagrad_state_from_jax, novograd_state_from_jax)
from apex_tpu_torch.utils.pytree import tree_leaves

from _torch_port import amp_uninit  # noqa: F401  (autouse)

STEPS = 5
TOL = 1e-6


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": (rng.standard_normal((8, 16)) * 0.3
                            ).astype(np.float32),
                      "b": (rng.standard_normal(16) * 0.1).astype(np.float32)},
            "conv": (rng.standard_normal((3, 5, 7)) * 0.2).astype(np.float32),
            "ln_g": np.ones(16, np.float32)}


def _grads(tree, step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.5 * scale
                   ).astype(np.float32), tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def close(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    ok = err <= TOL * np.maximum(1.0, np.abs(ref))
    assert ok.all(), f"{what}: max err {err.max():.3g} (tol {TOL} relative)"


def _run(jopt, popt, tree, steps=STEPS):
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = _torch(tree)
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(steps):
        g = _grads(tree, step)
        jp, js = jopt.step(js, jax.tree_util.tree_map(jnp.asarray, g), jp)
        pp, ps = popt.step(ps, _torch(g), pp)
    return jp, js, pp, ps


def _check(jp, js, pp, ps):
    assert int(ps.count) == int(js.count) == STEPS
    for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
        close(a.numpy(), np.asarray(b), "params")
    for field in js._fields[1:]:
        jl = jax.tree_util.tree_leaves(getattr(js, field))
        pl = tree_leaves(getattr(ps, field))
        assert len(jl) == len(pl), field
        for a, b in zip(pl, jl):
            close(a.numpy(), np.asarray(b), field)


ADAGRAD_CASES = [
    ("plain", {}),
    ("weight_decay", dict(weight_decay=0.01)),
    ("eps", dict(eps=1e-3, lr=5e-2)),
    ("lr_schedule", dict(lr=lambda c: 1e-2 / c)),
]


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("name,kw", ADAGRAD_CASES,
                         ids=[c[0] for c in ADAGRAD_CASES])
def test_adagrad_matches_jax(name, kw, impl):
    jkw = dict(kw)
    if callable(kw.get("lr")):
        jkw["lr"] = lambda c: 1e-2 / c.astype(jnp.float32)
    _check(*_run(JAdagrad(impl=impl, **jkw), FusedAdagrad(impl=impl, **kw),
                 _tree()))


NOVOGRAD_CASES = [
    ("default", {}),
    ("weight_decay", dict(weight_decay=0.01)),
    ("reg_inside_moment", dict(weight_decay=0.01, reg_inside_moment=True)),
    ("no_grad_averaging", dict(grad_averaging=False)),
    ("norm_type_0", dict(norm_type=0, weight_decay=0.01)),
    ("init_zero", dict(init_zero=True)),
    ("init_zero_norm_0", dict(init_zero=True, norm_type=0)),
    ("no_bias_correction", dict(bias_correction=False, weight_decay=0.01)),
    ("betas", dict(betas=(0.9, 0.999), lr=1e-2)),
]


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("name,kw", NOVOGRAD_CASES,
                         ids=[c[0] for c in NOVOGRAD_CASES])
def test_novograd_matches_jax(name, kw, impl):
    _check(*_run(JNovoGrad(impl=impl, **kw), FusedNovoGrad(impl=impl, **kw),
                 _tree()))


def test_novograd_refuses_amsgrad_and_bad_norm(tmp_path):
    """The refusals; and the sharded update (weight-update sharding), once
    refused, over a world-1 shard is ``step_flat``'s bits in both norm
    types."""
    import _torch_dist
    from apex_tpu_torch.parallel.weight_update import ShardContext
    from apex_tpu_torch.utils.pytree import tree_map
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(amsgrad=True)
    with pytest.raises(ValueError, match="norm_type"):
        FusedNovoGrad(norm_type=1)

    def run(rank, world):
        out = []
        for norm_type in (2, 0):
            opt = FusedNovoGrad(impl="fused", lr=1e-2, norm_type=norm_type)
            params = tree_map(torch.from_numpy, _tree())
            st = opt.init(params)
            g = opt.flattener.flatten(tree_map(lambda v: v * 0.5 + 0.1,
                                               params))
            whole = opt.step_flat(st, g)
            shard = opt.step_flat_shard(
                st, g, shard=ShardContext(None, opt.flattener, 1))
            out.append(all(torch.equal(a, b) for a, b in zip(whole, shard)))
        return out

    assert _torch_dist.run_in_process(run, tmp_path) == [True, True]


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_adagrad_matches_torch_optim(impl, wd):
    tree = _tree(3)
    pp = _torch(tree)
    popt = FusedAdagrad(lr=5e-2, weight_decay=wd, impl=impl)
    ps = popt.init(pp)
    ref = [torch.from_numpy(np.array(l)).requires_grad_(True)
           for l in jax.tree_util.tree_leaves(tree)]
    topt = torch.optim.Adagrad(ref, lr=5e-2, weight_decay=wd, eps=1e-10)
    for step in range(STEPS):
        g = _grads(tree, step)
        pp, ps = popt.step(ps, _torch(g), pp)
        for p, gl in zip(ref, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(np.array(gl))
        topt.step()
    for a, b in zip(tree_leaves(pp), ref):
        close(a.numpy(), b.detach().numpy(), "params vs torch.optim")


AMP_OPTS = [("adagrad", FusedAdagrad, JAdagrad),
            ("novograd", FusedNovoGrad, JNovoGrad)]


@pytest.mark.parametrize("opt_level", ["O2", "O5"])
@pytest.mark.parametrize("name,pcls,jcls", AMP_OPTS,
                         ids=[c[0] for c in AMP_OPTS])
def test_amp_flat_fast_path(name, pcls, jcls, opt_level):
    """Under amp the fused impl keeps its masters flat in the optimizer
    state and steps through ``step_flat``: the same trajectory as the xla
    impl under amp, and as the JAX package's fused impl under its amp."""
    tree = _tree(5)
    kw = dict(lr=1e-2, weight_decay=0.01)
    st_x = amp.initialize(_torch(tree), pcls(**kw), opt_level=opt_level,
                          verbosity=0)
    st_f = amp.initialize(_torch(tree), pcls(impl="fused", **kw),
                          opt_level=opt_level, verbosity=0)
    st_j = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, tree),
                           jcls(impl="fused", **kw), opt_level=opt_level,
                           verbosity=0)
    assert st_x.master_params is not None and st_f.master_params is None
    assert st_f.opt_state.master is not None
    for i in range(4):
        g = _grads(tree, i, float(st_f.loss_scale))
        st_x = amp.amp_step(st_x, _torch(g))
        st_f = amp.amp_step(st_f, _torch(g))
        st_j = jamp.amp_step(st_j, jax.tree_util.tree_map(jnp.asarray, g))
    for a, b, c in zip(tree_leaves(st_f.params_for_eval()),
                       tree_leaves(st_x.params_for_eval()),
                       jax.tree_util.tree_leaves(st_j.params_for_eval())):
        close(a.numpy(), b.numpy(), "fused vs xla")
        close(a.numpy(), np.asarray(c), "port vs jax")
    for a, b in zip(tree_leaves(st_f.model_params),
                    tree_leaves(st_x.model_params)):
        assert a.dtype == b.dtype


def _jax_states(seed):
    rng = np.random.default_rng(seed)

    def tr():
        return {"a": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
                "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}

    def sc():
        return {"a": jnp.asarray(rng.random(), jnp.float32),
                "b": jnp.asarray(rng.random(), jnp.float32)}

    def flat(n=17):
        return jnp.asarray(rng.standard_normal(n), jnp.float32)
    return {
        "adagrad": JAdaState(jnp.int32(3), tr()),
        "adagrad_fused": JAdaState(jnp.int32(2), flat(), flat()),
        "novograd": JNovoState(jnp.int32(5), tr(), sc()),
        "novograd_fused": JNovoState(jnp.int32(1), flat(), flat(2), flat()),
    }


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.mark.parametrize("kind", sorted(_jax_states(0)))
def test_states_cross_checkpoints_both_ways(kind, tmp_path):
    jst = _jax_states(3)[kind]
    conv = adagrad_state_from_jax if kind.startswith("adagrad") \
        else novograd_state_from_jax
    pcls = FusedAdagradState if kind.startswith("adagrad") \
        else FusedNovoGradState
    pst = conv(jax.tree_util.tree_map(np.asarray, jst), device="cpu")
    assert type(pst) is pcls
    pj = str(tmp_path / "j.ckpt")
    jckpt.save(pj, opt=jst)
    got = checkpoint.load(pj)["opt"]
    assert type(got) is pcls
    tmpl = conv(jax.tree_util.tree_map(np.zeros_like, jst), device="cpu")
    restored = checkpoint.restore_like(tmpl, got)
    assert type(restored) is pcls
    for a, b in zip(tree_leaves(restored), jax.tree_util.tree_leaves(jst)):
        assert _bits(a) == _bits(b)
    pt = str(tmp_path / "t.ckpt")
    checkpoint.save(pt, opt=pst)
    jgot = jckpt.load(pt)["opt"]
    assert type(jgot) is type(jst)
    jres = jckpt.restore_like(jax.tree_util.tree_map(jnp.zeros_like, jst),
                              jgot)
    for a, b in zip(jax.tree_util.tree_leaves(jres), tree_leaves(pst)):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("name", ["adagrad", "novograd"])
def test_state_from_jax_continues_the_run(name, impl):
    """Two JAX steps, the state carried over, three more steps in each
    package: the same params."""
    jcls, pcls, conv = {
        "adagrad": (JAdagrad, FusedAdagrad, adagrad_state_from_jax),
        "novograd": (JNovoGrad, FusedNovoGrad, novograd_state_from_jax),
    }[name]
    tree = _tree(7)
    jopt, popt = jcls(impl=impl, lr=1e-2), pcls(impl=impl, lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jopt.init(jp)
    for step in range(2):
        jp, js = jopt.step(js, jax.tree_util.tree_map(
            jnp.asarray, _grads(tree, step)), jp)
    pp = _torch(jax.tree_util.tree_map(np.asarray, jp))
    popt.init(pp)                       # the fused impl's flattener
    ps = conv(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for step in range(2, STEPS):
        g = _grads(tree, step)
        jp, js = jopt.step(js, jax.tree_util.tree_map(jnp.asarray, g), jp)
        pp, ps = popt.step(ps, _torch(g), pp)
    _check(jp, js, pp, ps)
