"""``contrib.multihead_attn`` of the PyTorch port against the JAX package.

The same numpy inputs and weights (a JAX module's ``init_params``, carried
over by ``mha_params_from_jax``) go through ``apex_tpu``'s modules and
functions and through the port's, at E 64, H 4 (as
``tests/L0/test_multihead_attn.py``).  The JAX fast path runs its Pallas
flash kernels in interpret mode on the CPU; the port's takes its flash
wrappers' plain versions on CPU tensors.  Tolerances (peak rule: an
element passes within ``tol * max(|ref|, min(1, max|ref|))``): port vs JAX
at the same impl, forward 1e-5 and gradients 1e-4, fp32; fast vs default
2e-3, the JAX suite's ``ATOL``.  The fast path's dropout is compared with
one kernel seed in both packages (the counter-hash mask); the default
path's dropout draws from a ``torch.Generator``, so its keep rate is
tested instead of its bits.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as JEncdec, SelfMultiheadAttn as JSelf,
    encdec_attn_func as j_encdec_func,
    fast_mask_softmax_dropout_func as j_msd, self_attn_func as j_self_func)
from apex_tpu.contrib.multihead_attn import functional as jfun
from apex_tpu.contrib.multihead_attn import modules as jmod

from apex_tpu_torch.contrib import multihead_attn as pmha
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn, SelfMultiheadAttn, encdec_attn_func,
    fast_mask_softmax_dropout_func, mha_params_from_jax, self_attn_func)
from apex_tpu_torch.contrib.multihead_attn import functional as pfun
from apex_tpu_torch.contrib.multihead_attn.modules import _is_causal_mask

E, H = 64, 4
FWD, GRAD, FAST_VS_DEFAULT = 1e-5, 1e-4, 2e-3
SQ, SK, B = 32, 40, 3


def peak_close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    a = np.abs(ref)
    floor = min(1.0, float(a.max())) if a.size else 1.0
    err = np.abs(got - ref)
    ok = err <= tol * np.maximum(a, floor)
    assert ok.all(), f"{what}: max err {err.max():.3g} (tol {tol}, peak rule)"


def t(a):
    return torch.from_numpy(np.array(a))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mask(kind, b, sq, sk, seed=0):
    """(numpy mask, key_padding?) for a mask kind; no row fully masked."""
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None, None
    if kind == "key_pad":
        m = np.zeros((b, sk), bool)
        for i in range(b):
            m[i, sk - 3 - 2 * i:] = True
        return m, True
    if kind == "additive":
        m = np.zeros((b, sk), np.float32)
        m[:, sk - 5:] = -1e9
        m[:, :3] = rng.standard_normal((b, 3))
        return m, True
    if kind == "time":
        m = rng.random((sq, sk)) < 0.3
        m[:, 0] = False
        return m, False
    # "causal": the strict upper triangle (not square for encdec)
    return ~np.tril(np.ones((sq, sk), bool)), False


def _mask_kw(mask, key_padding):
    if mask is None:
        return {}
    if key_padding:
        return {"key_padding_mask": mask}
    return {"attn_mask": mask}


def _pair(kind, impl, module="self", jkey=0, **kw):
    """(JAX module, its params as numpy, port module loaded from them)."""
    if module == "self":
        jm = JSelf(E, H, impl=impl, **kw)
        pm_cls = SelfMultiheadAttn
    else:
        jm = JEncdec(E, H, impl=impl, **kw)
        pm_cls = EncdecMultiheadAttn
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(jkey)))
    pm = pm_cls(E, H, impl=impl, device="cpu",
                generator=torch.Generator().manual_seed(7), **kw)
    pm.load_state_dict(mha_params_from_jax(params))
    return jm, params, pm


def _module_kw(module, kind):
    if module == "self":
        return dict(bias=True, include_norm_add=kind != "additive",
                    mask_additive=kind == "additive")
    return dict(include_norm_add=True)


def _run_both(jm, params, pm, xq, xk, mkw, cot, *, jrng=None, prng=None,
              training=False):
    """(JAX out, JAX grads, port out, port grads) of sum(out * cot)."""
    encdec = isinstance(pm, EncdecMultiheadAttn)
    jmkw = {k: jnp.asarray(v) for k, v in mkw.items()}

    def jloss(p):
        args = (jnp.asarray(xq), jnp.asarray(xk)) if encdec else (
            jnp.asarray(xq),)
        out, _ = jm(p, *args, is_training=training, dropout_rng=jrng,
                    **jmkw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    pmkw = {k: t(v) for k, v in mkw.items()}
    args = (t(xq), t(xk)) if encdec else (t(xq),)
    pout, none = pm(*args, is_training=training, dropout_rng=prng, **pmkw)
    assert none is None
    (pout * t(cot)).sum().backward()
    pg = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    return np.asarray(jout), {k: np.asarray(v) for k, v in jg.items()}, \
        pout.detach().numpy(), pg


SELF_KINDS = ["none", "key_pad", "additive", "time", "causal"]
ENCDEC_KINDS = ["none", "key_pad", "time", "causal"]   # no additive mask
MODULE_CASES = ([("self", k) for k in SELF_KINDS]
                + [("encdec", k) for k in ENCDEC_KINDS])


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("module,kind", MODULE_CASES,
                         ids=[f"{m}-{k}" for m, k in MODULE_CASES])
def test_module_matches_jax(module, kind, impl):
    """Forward and every parameter's gradient, port vs JAX, same impl."""
    sk = SQ if module == "self" else SK
    mask, kp = _mask(kind, B, SQ, sk, seed=3)
    jm, params, pm = _pair(kind, impl, module, **_module_kw(module, kind))
    xq, xk = _x((SQ, B, E), 1), _x((sk, B, E), 2)
    cot = _x((SQ, B, E), 4)
    jout, jg, pout, pg = _run_both(jm, params, pm, xq, xk,
                                   _mask_kw(mask, kp), cot)
    peak_close(pout, jout, FWD, "out")
    assert sorted(pg) == sorted(jg)
    for name in jg:
        peak_close(pg[name], jg[name], GRAD, name)


@pytest.mark.parametrize("module,kind", MODULE_CASES,
                         ids=[f"{m}-{k}" for m, k in MODULE_CASES])
def test_module_fast_matches_default(module, kind):
    """The port's two impls on one set of weights (2e-3, as the JAX suite
    holds its own fast path to its default)."""
    sk = SQ if module == "self" else SK
    mask, kp = _mask(kind, B, SQ, sk, seed=5)
    kw = _module_kw(module, kind)
    _, params, fast = _pair(kind, "fast", module, **kw)
    _, _, dflt = _pair(kind, "default", module, **kw)
    xq, xk = t(_x((SQ, B, E), 6)), t(_x((sk, B, E), 7))
    args = (xq, xk) if module == "encdec" else (xq,)
    mkw = {k: t(v) for k, v in _mask_kw(mask, kp).items()}
    outs = []
    for m in (fast, dflt):
        out, _ = m(*args, is_training=False, **mkw)
        (out ** 2).sum().backward()
        outs.append((out.detach().numpy(),
                     {n: p.grad.numpy() for n, p in m.named_parameters()}))
    (fo, fg), (do, dg) = outs
    np.testing.assert_allclose(fo, do, atol=FAST_VS_DEFAULT, rtol=1e-3)
    for n in fg:
        peak_close(fg[n], dg[n], FAST_VS_DEFAULT, n)


def test_dead_rows_zero_on_fast_nan_on_default():
    """A batch row whose keys are all padded: the kernel path emits zeros
    (as the JAX package's does), the default path NaN (as its does); the
    live rows agree across packages and impls."""
    mask = np.zeros((B, SQ), bool)
    mask[0, :] = True
    mask[1, SQ - 4:] = True
    xq = _x((SQ, B, E), 8)
    outs = {}
    for impl in ("fast", "default"):
        jm, params, pm = _pair("key_pad", impl, bias=True)
        jout, _ = jm(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(xq), key_padding_mask=jnp.asarray(mask),
                     is_training=False)
        pout, _ = pm(t(xq), key_padding_mask=t(mask), is_training=False)
        outs[impl] = (np.asarray(jout), pout.detach().numpy())
    jf, pf = outs["fast"]
    jd, pd = outs["default"]
    # the dead row's context is 0: only the output projection's bias stays
    np.testing.assert_array_equal(pf[:, 0], np.broadcast_to(
        pf[0, 0], pf[:, 0].shape))
    assert np.isnan(pd[:, 0]).all() and np.isnan(jd[:, 0]).all()
    peak_close(pf, jf, FWD, "fast")
    peak_close(pd[:, 1:], jd[:, 1:], FWD, "default live rows")
    np.testing.assert_allclose(pf[:, 1:], pd[:, 1:], atol=FAST_VS_DEFAULT)


@pytest.mark.parametrize("module", ["self", "encdec"])
def test_fast_dropout_same_seed_as_jax(module):
    """Training with dropout 0.1: the JAX key's kernel seed
    (``_rng_seed_from``) given to the port as an int gives the same
    counter-hash mask, so the same output and gradients."""
    sk = SQ if module == "self" else SK
    kw = dict(bias=True) if module == "self" else {}
    jm, params, pm = _pair("none", "fast", module, dropout=0.1, **kw)
    key = jax.random.PRNGKey(11)
    seed = int(jmod._rng_seed_from(key))
    xq, xk = _x((SQ, B, E), 9), _x((sk, B, E), 10)
    cot = _x((SQ, B, E), 12)
    jout, jg, pout, pg = _run_both(jm, params, pm, xq, xk, {}, cot,
                                   jrng=key, prng=seed, training=True)
    peak_close(pout, jout, FWD, "out")
    for name in jg:
        peak_close(pg[name], jg[name], GRAD, name)
    # and the dropout did act: the eval output differs
    evl, _ = pm(*((t(xq), t(xk)) if module == "encdec" else (t(xq),)),
                is_training=False)
    assert np.abs(evl.detach().numpy() - pout).max() > 1e-3


def test_no_rng_means_no_dropout_on_every_impl():
    xq = t(_x((SQ, B, E), 13))
    for impl in ("fast", "default"):
        _, _, pm = _pair("none", impl, dropout=0.5, include_norm_add=True)
        a, _ = pm(xq, is_training=True)
        b, _ = pm(xq, is_training=False)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_default_dropout_keep_rate_and_determinism():
    """attention_core's dropout keeps 1 - rate of the probabilities (the
    JAX package draws jax.random.bernoulli at the same rate), scales the
    kept ones by 1 / (1 - rate), and repeats for one generator seed.  v is
    the identity over the keys, so the output is the probabilities."""
    rate = 0.25
    rng = np.random.default_rng(14)
    q, k = (t(rng.standard_normal((2, 4, 64, 16)).astype(np.float32))
            for _ in range(2))
    v = torch.eye(64).expand(2, 4, 64, 64)
    bias = torch.zeros((1, 1, 64))

    def run(seed):
        return pfun.attention_core(
            q, k, v, bias, dropout_rate=rate,
            dropout_rng=torch.Generator().manual_seed(seed))
    ref = pfun.attention_core(q, k, v, bias)
    got = run(3)
    kept = got != 0
    keep_rate = float(kept.float().mean())
    assert abs(keep_rate - (1 - rate)) < 0.01, keep_rate
    torch.testing.assert_close(got[kept], ref[kept] / (1 - rate))
    torch.testing.assert_close(got, run(3), rtol=0, atol=0)
    assert not torch.equal(got, run(4))
    jp = jfun.attention_core(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                             jnp.asarray(v.numpy()), jnp.zeros((1, 1, 64)),
                             dropout_rate=rate,
                             dropout_rng=jax.random.PRNGKey(3))
    assert abs(float((np.asarray(jp) != 0).mean()) - (1 - rate)) < 0.01


def test_default_module_dropout_with_int_and_generator():
    """The default impl and the residual dropout take an int seed or a
    generator: the same seed gives the same bits, another seed others."""
    xq = t(_x((SQ, B, E), 15))
    _, _, pm = _pair("none", "default", dropout=0.2, include_norm_add=True)
    a, _ = pm(xq, dropout_rng=5)
    b, _ = pm(xq, dropout_rng=5)
    c, _ = pm(xq, dropout_rng=6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    g1, _ = pm(xq, dropout_rng=torch.Generator().manual_seed(9))
    g2, _ = pm(xq, dropout_rng=torch.Generator().manual_seed(9))
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)


@pytest.mark.parametrize("backward", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("module", ["self", "encdec"])
def test_backward_choice_matches_jax(module, backward):
    sk = SQ if module == "self" else SK
    mask, kp = _mask("key_pad", B, SQ, sk, seed=16)
    jm, params, pm = _pair("key_pad", "fast", module, backward=backward,
                           **_module_kw(module, "key_pad"))
    xq, xk = _x((SQ, B, E), 17), _x((sk, B, E), 18)
    jout, jg, pout, pg = _run_both(jm, params, pm, xq, xk,
                                   _mask_kw(mask, kp), _x((SQ, B, E), 19))
    peak_close(pout, jout, FWD, "out")
    for name in jg:
        peak_close(pg[name], jg[name], GRAD, name)


@pytest.mark.parametrize("cls,kw,exc", [
    (SelfMultiheadAttn, dict(backward="bogus"), AssertionError),
    (EncdecMultiheadAttn, dict(backward="bogus"), AssertionError),
    (SelfMultiheadAttn, dict(impl="bogus"), AssertionError),
    (EncdecMultiheadAttn, dict(impl="ring"), AssertionError),
    (EncdecMultiheadAttn, dict(bias=True), AssertionError),
    (SelfMultiheadAttn, dict(mask_additive=True, include_norm_add=True),
     AssertionError),
    (SelfMultiheadAttn, dict(seq_inner_impl="bogus"), AssertionError),
    (SelfMultiheadAttn, dict(seq_inner_impl="fast"), AssertionError),
    (SelfMultiheadAttn, dict(impl="ring"), NotImplementedError),
    (SelfMultiheadAttn, dict(impl="ulysses", seq_inner_impl="fast"),
     NotImplementedError),
], ids=["self-backward", "encdec-backward", "self-impl", "encdec-ring",
        "encdec-bias", "additive-norm-add", "seq-inner-bogus",
        "seq-inner-fast-not-ulysses", "ring", "ulysses"])
def test_constructor_checks(cls, kw, exc):
    jcls = JSelf if cls is SelfMultiheadAttn else JEncdec
    if exc is AssertionError:      # the JAX modules refuse the same
        with pytest.raises(AssertionError):
            jcls(E, H, **kw)
        with pytest.raises(exc):
            cls(E, H, device="cpu", **kw)
        return
    # the sequence-parallel impls construct, and refuse a per-call mask
    # before any collective, as the JAX modules do
    jm = jcls(E, H, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    mask = np.zeros((2, 8), bool)
    with pytest.raises(exc, match="per-call masks"):
        jm(params, jnp.asarray(_x((8, 2, E), 21)),
           key_padding_mask=jnp.asarray(mask), is_training=False)
    pm = cls(E, H, device="cpu", **kw)
    with pytest.raises(exc, match="per-call masks"):
        pm(t(_x((8, 2, E), 21)), key_padding_mask=t(mask),
           is_training=False)


def test_call_checks():
    _, _, pm = _pair("none", "fast", mask_additive=True, bias=True)
    xq = t(_x((8, 2, E), 20))
    with pytest.raises(AssertionError, match="additive"):
        pm(xq, attn_mask=torch.zeros(8, 8, dtype=torch.bool))
    _, _, pm = _pair("none", "fast")
    with pytest.raises(AssertionError, match="both"):
        pm(xq, key_padding_mask=torch.zeros(2, 8, dtype=torch.bool),
           attn_mask=torch.zeros(8, 8, dtype=torch.bool))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfMultiheadAttn(E, H)


def test_params_from_jax_names_and_init_rule():
    """The port's parameters carry the JAX pytree's names and shapes, and
    its own draws follow the same Xavier bounds."""
    for jm, pm in ((JSelf(E, H, bias=True, include_norm_add=True),
                    SelfMultiheadAttn(E, H, bias=True, include_norm_add=True,
                                      device="cpu")),
                   (JSelf(E, H, bias=True, separate_qkv_params=True),
                    SelfMultiheadAttn(E, H, bias=True, device="cpu",
                                      separate_qkv_params=True)),
                   (JEncdec(E, H, include_norm_add=True),
                    EncdecMultiheadAttn(E, H, include_norm_add=True,
                                        device="cpu"))):
        jp = jm.init_params(jax.random.PRNGKey(0))
        sd = pm.state_dict()
        assert sorted(sd) == sorted(jp)
        for k in jp:
            assert tuple(sd[k].shape) == tuple(jp[k].shape), k
            a = float(np.abs(np.asarray(jp[k])).max())
            b = float(sd[k].abs().max())
            if a == 0 or a == 1:                  # zeros / ones
                assert b == a, k
            else:                                 # the same uniform bound
                assert 0.8 * a < b <= a * 1.01, (k, a, b)
        pm.load_state_dict(mha_params_from_jax(jp))


def test_separate_qkv_params_keep_the_jax_block_split():
    """ROADMAP.md Queue 3: separate q/k/v weights interleave per head,
    (H, 3, D, E) -> (3E, E), and the call splits that matrix as (3, E)
    blocks.  The port reproduces the JAX package's numbers, which equal a
    fused module loaded with the interleaved matrix and differ from one
    loaded with the plain [q; k; v] stack."""
    jm, params, pm = _pair("none", "default", separate_qkv_params=True,
                           bias=True)
    xq = _x((16, 2, E), 21)
    cot = _x((16, 2, E), 22)
    jout, jg, pout, pg = _run_both(jm, params, pm, xq, None, {}, cot)
    peak_close(pout, jout, FWD, "out")
    for name in jg:
        peak_close(pg[name], jg[name], GRAD, name)
    w, b = jm._input_weights(jax.tree_util.tree_map(jnp.asarray, params))
    fused = {"in_proj_weight": np.asarray(w), "in_proj_bias": np.asarray(b),
             "out_proj_weight": params["out_proj_weight"],
             "out_proj_bias": params["out_proj_bias"]}
    plain = dict(fused, in_proj_weight=np.concatenate(
        [params["q_weight"], params["k_weight"], params["v_weight"]]),
        in_proj_bias=np.concatenate(
            [params["q_bias"], params["k_bias"], params["v_bias"]]))
    mod = SelfMultiheadAttn(E, H, bias=True, impl="default", device="cpu")
    mod.load_state_dict(mha_params_from_jax(fused))
    inter, _ = mod(t(xq), is_training=False)
    np.testing.assert_allclose(inter.detach().numpy(), pout, atol=1e-6)
    mod.load_state_dict(mha_params_from_jax(plain))
    stacked, _ = mod(t(xq), is_training=False)
    assert np.abs(stacked.detach().numpy() - pout).max() > 1e-2


def test_is_causal_mask():
    tri = ~np.tril(np.ones((6, 6), bool))
    assert _is_causal_mask(t(tri)) and jmod._is_causal_mask(tri)
    assert not _is_causal_mask(t(~np.tril(np.ones((6, 7), bool))))
    off = tri.copy()
    off[0, 1] = False
    assert not _is_causal_mask(t(off)) and not jmod._is_causal_mask(off)
    assert not _is_causal_mask(None)


def test_causal_mask_takes_the_causal_route(monkeypatch):
    """The strict upper triangle reaches flash_attention as a zero (1, 1,
    S) bias with causal=True; any other (S, S) time mask as a (1, S, S)
    bias with causal=False."""
    from apex_tpu_torch.contrib.multihead_attn import modules as pm_mod
    seen = []
    real = pm_mod.flash_attention

    def spy(q, k, v, bias, seed, causal, *rest):
        seen.append((tuple(bias.shape), causal, float(bias.abs().max())))
        return real(q, k, v, bias, seed, causal, *rest)
    monkeypatch.setattr(pm_mod, "flash_attention", spy)
    _, _, pm = _pair("none", "fast")
    xq = t(_x((SQ, 2, E), 23))
    pm(xq, attn_mask=t(_mask("causal", 2, SQ, SQ)[0]), is_training=False)
    pm(xq, attn_mask=t(_mask("time", 2, SQ, SQ)[0]), is_training=False)
    assert seen[0] == ((1, 1, SQ), True, 0.0)
    assert seen[1][:2] == ((1, SQ, SQ), False)
    assert seen[1][2] == float(np.float32(1e30))    # -inf -> -1e30


# ---------------------------------------------------------------------------
# functional
# ---------------------------------------------------------------------------

BIAS_CASES = [
    ("none", None, False, False),
    ("additive_1d", np.array([0.0, -1.0, 2.0, -1e9], np.float32), True,
     False),
    ("additive_2d", np.array([[0.0, -1.0, 2.0, -1e9],
                              [1.0, 0.5, -1e9, 0.0]], np.float32), True,
     False),
    ("time", np.triu(np.ones((3, 4), bool), 1), False, True),
    ("key_pad_bool", np.array([[0, 0, 1, 1], [0, 0, 0, 1]], bool), False,
     False),
    ("key_pad_int", np.array([[0, 0, 1, 1], [0, 0, 0, 1]], np.int32), False,
     False),
]


@pytest.mark.parametrize("name,mask,additive,time_mask", BIAS_CASES,
                         ids=[c[0] for c in BIAS_CASES])
def test_build_bias_matches_jax(name, mask, additive, time_mask):
    kw = dict(batch=2, sq=3, sk=4, use_time_mask=time_mask)
    jb = np.asarray(jfun.build_bias(None if mask is None else
                                    jnp.asarray(mask), additive, **kw))
    pb = pfun.build_bias(None if mask is None else t(mask), additive, **kw)
    assert pb.dtype == torch.float32
    np.testing.assert_array_equal(pb.numpy(), jb)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["zeros", "key_pad", "full"])
def test_attention_core_matches_jax(bias_kind, causal):
    rng = np.random.default_rng(24)
    b, h, sq, sk, d = 2, 3, 12, 12, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    bias = {"zeros": np.zeros((1, 1, sk), np.float32),
            "key_pad": np.where(np.arange(sk)[None, None] >= sk - 2 - np.arange(b)[:, None, None],
                                -1e9, 0.0).astype(np.float32),
            "full": rng.standard_normal((b, sq, sk)).astype(np.float32)
            }[bias_kind]
    jo = jfun.attention_core(*(jnp.asarray(a) for a in (q, k, v, bias)),
                             causal=causal)
    po = pfun.attention_core(*(t(a) for a in (q, k, v, bias)),
                             causal=causal)
    peak_close(po.numpy(), np.asarray(jo), FWD)


def _func_weights(seed):
    rng = np.random.default_rng(seed)
    return {"in": (rng.standard_normal((3 * E, E)) * 0.05).astype(np.float32),
            "q": (rng.standard_normal((E, E)) * 0.05).astype(np.float32),
            "kv": (rng.standard_normal((2 * E, E)) * 0.05).astype(np.float32),
            "out": (rng.standard_normal((E, E)) * 0.05).astype(np.float32),
            "in_b": (rng.standard_normal(3 * E) * 0.1).astype(np.float32),
            "out_b": (rng.standard_normal(E) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("kind", ["none", "key_pad", "additive", "time"])
def test_self_attn_func_matches_jax(kind):
    w = _func_weights(25)
    x = _x((16, 2, E), 26)
    mask, kp = _mask(kind, 2, 16, 16, seed=27)
    time_mask = kind == "time"
    additive = kind == "additive"
    scale = (E // H) ** -0.5
    names = ("in", "out", "in_b", "out_b")

    def jf(x, *ws):
        return j_self_func(time_mask, False, H, scale, x, ws[0], ws[1],
                           ws[2], ws[3], None if mask is None
                           else jnp.asarray(mask), additive, 0.0)
    cot = _x((16, 2, E), 28)
    jargs = [jnp.asarray(x)] + [jnp.asarray(w[n]) for n in names]
    jo = jf(*jargs)
    jg = jax.grad(lambda *a: jnp.sum(jf(*a) * cot), argnums=tuple(
        range(5)))(*jargs)
    pargs = [t(x).requires_grad_(True)] + [t(w[n]).requires_grad_(True)
                                          for n in names]
    po = self_attn_func(time_mask, False, H, scale, pargs[0], pargs[1],
                        pargs[2], pargs[3], pargs[4],
                        None if mask is None else t(mask), additive, 0.0)
    peak_close(po.detach().numpy(), np.asarray(jo), FWD, "out")
    (po * t(cot)).sum().backward()
    for a, g in zip(pargs, jg):
        peak_close(a.grad.numpy(), np.asarray(g), GRAD)


@pytest.mark.parametrize("kind", ["none", "key_pad", "time"])
def test_encdec_attn_func_matches_jax(kind):
    w = _func_weights(29)
    xq, xk = _x((12, 2, E), 30), _x((20, 2, E), 31)
    mask, _ = _mask(kind, 2, 12, 20, seed=32)
    time_mask = kind == "time"
    scale = (E // H) ** -0.5
    jo = j_encdec_func(time_mask, False, H, scale, jnp.asarray(xq),
                       jnp.asarray(xk), jnp.asarray(w["q"]),
                       jnp.asarray(w["kv"]), jnp.asarray(w["out"]),
                       None if mask is None else jnp.asarray(mask), 0.0)
    po = encdec_attn_func(time_mask, False, H, scale, t(xq), t(xk),
                          t(w["q"]), t(w["kv"]), t(w["out"]),
                          None if mask is None else t(mask), 0.0)
    peak_close(po.numpy(), np.asarray(jo), FWD)


@pytest.mark.parametrize("pad", ["none", "bool", "additive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_softmax_dropout_matches_jax(pad, dtype):
    rng = np.random.default_rng(33)
    b, sq, sk = 2, 6, 10
    s = rng.standard_normal((b * H, sq, sk)).astype(np.float32)
    m = None
    if pad == "bool":
        m = np.zeros((b, sk), bool)
        m[:, -3:] = True
    elif pad == "additive":
        m = (rng.standard_normal((b, sk)) * 2).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jo = j_msd(True, H, jnp.asarray(s).astype(jdt),
               None if m is None else jnp.asarray(m), pad == "additive", 0.1)
    po = fast_mask_softmax_dropout_func(
        True, H, t(s).to(tdt), None if m is None else t(m),
        pad == "additive", 0.1)          # no rng: no dropout in either
    assert po.dtype == tdt
    peak_close(po.float().numpy(), np.asarray(jo.astype(jnp.float32)),
               FWD if dtype == "float32" else 2 ** -8)


def test_mask_softmax_dropout_keep_rate():
    s = t(np.zeros((8, 32, 64), np.float32))
    p = fast_mask_softmax_dropout_func(
        True, H, s, None, False, 0.3,
        dropout_rng=torch.Generator().manual_seed(1))
    kept = p != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(p[kept], torch.full_like(p[kept],
                                                        1 / 64 / 0.7))


def test_exports_match_jax_package():
    import apex_tpu.contrib.multihead_attn as jpkg
    assert set(jpkg.__all__) <= set(pmha.__all__)
    for name in jpkg.__all__:
        assert callable(getattr(pmha, name)), name


STACK_CASES = [("self", "fast", "novograd"), ("self", "default", "novograd"),
               ("encdec", "fast", "adagrad"), ("encdec", "default", "adagrad")]


@pytest.mark.parametrize("module,impl,opt_name", STACK_CASES,
                         ids=["-".join(c) for c in STACK_CASES])
def test_mha_train_step_matches_jax_stack(module, impl, opt_name):
    """``train.mha_train_step`` on a 2-layer stack with norm-add and key
    padding, 2 steps of FusedNovoGrad (self) or FusedAdagrad (encdec),
    ``impl="fused"``, against the same stack, loss and optimizer in the JAX
    package: the losses at 1e-5 relative and every parameter after the
    steps' update (parameters after less before) at 1e-3 relative in norm,
    since Adagrad's g / sqrt(sum g^2) turns the rounding of a gradient
    element near 0 into a change of up to lr in that element (no dropout:
    the default path's bits cannot match)."""
    from apex_tpu.optimizers import (FusedAdagrad as JAdagrad,
                                     FusedNovoGrad as JNovoGrad)
    from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
    from apex_tpu_torch.train import mha_apply, mha_params, mha_train_step
    sk = SQ if module == "self" else SK
    kw = dict(include_norm_add=True, dropout=0.1)
    if module == "self":
        kw["bias"] = True
    pairs = [_pair("key_pad", impl, module, jkey=i, **kw) for i in range(2)]
    jms = [p[0] for p in pairs]
    jparams = {str(i): jax.tree_util.tree_map(jnp.asarray, p[1])
               for i, p in enumerate(pairs)}
    stack = torch.nn.ModuleList(p[2] for p in pairs)
    mask, _ = _mask("key_pad", B, SQ, sk, seed=8)
    xq, xk, target = _x((SQ, B, E), 11), _x((sk, B, E), 12), \
        _x((SQ, B, E), 13)
    if opt_name == "novograd":
        jopt, opt = (JNovoGrad(lr=1e-2, impl="fused"),
                     FusedNovoGrad(lr=1e-2, impl="fused"))
    else:
        jopt, opt = (JAdagrad(lr=1e-3, impl="fused"),
                     FusedAdagrad(lr=1e-3, impl="fused"))

    def jloss(p):
        x = jnp.asarray(xq)
        for i, jm in enumerate(jms):
            args = (x, jnp.asarray(xk)) if module == "encdec" else (x,)
            x, _ = jm(p[str(i)], *args, is_training=True,
                      key_padding_mask=jnp.asarray(mask))
        return jnp.mean((x - jnp.asarray(target)) ** 2)

    jst = jopt.init(jparams)
    batch = {"query": t(xq), "target": t(target),
             "key_padding_mask": t(mask)}
    if module == "encdec":
        batch["key"] = t(xk)
    st = opt.init(mha_params(stack))
    before = {n: p.clone() for n, p in mha_params(stack).items()}
    marks = []
    for step in range(2):
        jl, jg = jax.value_and_grad(jloss)(jparams)
        jparams, jst = jopt.step(jst, jg, jparams)
        st, loss = mha_train_step(stack, opt, st, batch,
                                  mark=lambda: marks.append(step))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert marks == [0, 0, 1, 1]
    got = mha_params(stack)
    assert len(got) == sum(len(v) for v in jparams.values())
    for i in range(2):
        for name, ref in jparams[str(i)].items():
            n = f"{i}.{name}"
            d_ref = np.asarray(ref, np.float64) - before[n].numpy()
            d_got = got[n].numpy().astype(np.float64) - before[n].numpy()
            rel = np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref)
            assert rel <= 1e-3, f"{n}: update {rel:.3g} relative in norm"
    # mha_apply takes the encdec form from the batch alone
    with torch.no_grad():
        out = mha_apply(stack, batch)
    assert out.shape == (SQ, B, E)
