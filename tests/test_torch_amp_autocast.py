"""The O1 / O4 casts of the PyTorch port against the JAX package's.

The op table: for every entry of ``apex_tpu/amp/lists/jnp_overrides.py``
and every torch spelling the port lists for it
(``apex_tpu_torch/amp/lists/torch_overrides.py``), the JAX call under
``apex_tpu.amp.autocast(dt)`` and the port's under
``apex_tpu_torch.amp.autocast(dt)``, for dt bf16 and fp16, on the same
inputs (numpy, seeded) in three dtype mixes: all low precision, all fp32,
and the first input fp32 with the rest low precision.  Each pair gives the
same output dtype and values within the low-precision rule: ``|port -
jax| <= tol * max(1, |jax|)``, tol 2e-2 for bf16 and 4e-3 for fp16 (one
rounding of an fp32 result to the low-precision type, 2^-8 and 2^-11
relative, with room for sums in other orders).  The method and operator
forms (``a @ b``, ``x.sum()``, ``a + b``) are held the same way: neither
package casts them.

Completeness: every JAX list entry has a counterpart in the port's lists
and a case here.  The rest of amp mirrors ``tests/L0/test_amp.py`` and
``tests/L0/test_add_param_group.py`` test by test, and each test leaves
no casts behind (the ``amp_uninit`` fixture here, ``tests/conftest.py``
for the JAX package).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from torch.overrides import _get_current_function_mode_stack

from apex_tpu import amp as jamp
from apex_tpu.amp import amp as jamp_mod
from apex_tpu.amp.lists import jnp_overrides as JL
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.optimizers import FusedSGD as JaxSGD

from apex_tpu_torch import amp
from apex_tpu_torch.amp import amp as amp_mod
from apex_tpu_torch.amp.lists import torch_overrides as PL
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

from _torch_port import amp_uninit  # noqa: F401

LOW = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
       "float16": (jnp.float16, torch.float16, 4e-3)}
_TDT = {"float32": torch.float32, "float16": torch.float16,
        "bfloat16": torch.bfloat16, "bool": torch.bool}
_JNS = {"jnp": jnp, "lax": jax.lax, "nn": jax.nn, "linalg": jnp.linalg}


def _jfn(key):
    """The JAX callable of ``key``, looked up when called (so the patched
    attribute under autocast)."""
    ns, name = key.split(".")
    return getattr(_JNS[ns], name)


def _case(key, port, shapes, j, t=None, domain="any"):
    return dict(key=key, port=port, shapes=shapes, j=j, t=t or j,
                domain=domain)


def _unary(key, ports, domain="any", shape=(4, 6), j=None, t=None):
    j = j or (lambda f, x: f(x))
    return [_case(key, p, [shape], j, t, domain) for p in ports]


def _binary(key, ports, domain="any", shapes=((4, 6), (4, 6)), j=None,
            t=None):
    j = j or (lambda f, a, b: f(a, b))
    return [_case(key, p, list(shapes), j, t, domain) for p in ports]


def _cases():
    cs = []
    # --- low precision -----------------------------------------------------
    cs += _binary("jnp.dot", [torch.dot], shapes=((16,), (16,)))
    cs += _binary("jnp.matmul", [torch.matmul], shapes=((4, 8), (8, 3)))
    cs += _binary("jnp.vdot", [torch.vdot], shapes=((16,), (16,)))
    cs += _binary("jnp.inner", [torch.inner], shapes=((4, 8), (3, 8)))
    cs += _binary("jnp.outer", [torch.outer], shapes=((4,), (3,)))
    cs += _binary("jnp.tensordot", [torch.tensordot],
                  shapes=((4, 8), (8, 3)),
                  j=lambda f, a, b: f(a, b, axes=1),
                  t=lambda f, a, b: f(a, b, dims=1))
    cs += _binary("jnp.einsum", [torch.einsum], shapes=((4, 8), (8, 3)),
                  j=lambda f, a, b: f("ij,jk->ik", a, b))
    cs += _binary("lax.dot", [torch.mm], shapes=((4, 8), (8, 3)))
    dn_mm = (((1,), (0,)), ((), ()))
    dn_bmm = (((2,), (1,)), ((0,), (0,)))
    dn_lin = (((1,), (1,)), ((), ()))
    cs += _binary("lax.dot_general", [torch.mm], shapes=((4, 8), (8, 3)),
                  j=lambda f, a, b: f(a, b, dn_mm),
                  t=lambda f, a, b: f(a, b))
    cs += _binary("lax.dot_general", [torch.bmm],
                  shapes=((2, 4, 8), (2, 8, 3)),
                  j=lambda f, a, b: f(a, b, dn_bmm),
                  t=lambda f, a, b: f(a, b))
    cs += _binary("lax.dot_general", [F.linear], shapes=((4, 8), (3, 8)),
                  j=lambda f, a, b: f(a, b, dn_lin),
                  t=lambda f, a, b: f(a, b))
    conv_shapes = {1: ((2, 3, 9), (4, 3, 3)),
                   2: ((2, 3, 7, 7), (4, 3, 3, 3)),
                   3: ((2, 3, 5, 5, 5), (4, 3, 3, 3, 3))}
    tconv_shapes = {1: ((2, 4, 5), (4, 3, 3)),
                    2: ((2, 4, 5, 5), (4, 3, 3, 3)),
                    3: ((2, 4, 3, 3, 3), (4, 3, 3, 3, 3))}
    for n, conv, tconv in zip((1, 2, 3), PL._CONVS, PL._CONV_TRANSPOSES):
        cs += _binary("lax.conv", [conv], shapes=conv_shapes[n],
                      j=lambda f, x, w, n=n: f(x, w, (1,) * n, "VALID"),
                      t=lambda f, x, w: f(x, w))
        cs += _binary("lax.conv_general_dilated", [conv],
                      shapes=conv_shapes[n],
                      j=lambda f, x, w, n=n: f(x, w, (2,) * n, "VALID"),
                      t=lambda f, x, w: f(x, w, stride=2))
        # the gradient-of-convolution form: the kernel (in, out, k...) is
        # a forward convolution's OI... kernel, flipped and transposed by
        # transpose_kernel=True, as F.conv_transpose*d takes it
        spec = "DHW"[3 - n:]
        dn = ("NC" + spec, "OI" + spec, "NC" + spec)
        cs += _binary("lax.conv_transpose", [tconv], shapes=tconv_shapes[n],
                      j=lambda f, x, w, n=n, dn=dn: f(
                          x, w, (2,) * n, "VALID", dimension_numbers=dn,
                          transpose_kernel=True),
                      t=lambda f, x, w: f(x, w, stride=2))
    # --- fp32 --------------------------------------------------------------
    cs += _unary("jnp.exp", PL.FP32["jnp.exp"])
    cs += _unary("jnp.expm1", PL.FP32["jnp.expm1"])
    for k in ("jnp.log", "jnp.log10", "jnp.log1p", "jnp.log2"):
        cs += _unary(k, PL.FP32[k], domain="pos")
    cs += _binary("jnp.power", PL.FP32["jnp.power"], domain="pos")
    cs += _binary("jnp.float_power", PL.FP32["jnp.float_power"],
                  domain="pos")
    for k in ("jnp.cosh", "jnp.sinh", "jnp.tan", "jnp.arccos",
              "jnp.arcsin"):
        cs += _unary(k, PL.FP32[k], domain="unit")
    cs += _unary("jnp.arctan", PL.FP32["jnp.arctan"])
    along0 = dict(j=lambda f, x: f(x, axis=0), t=lambda f, x: f(x, dim=0))
    cs += _unary("jnp.cumprod", PL.FP32["jnp.cumprod"], domain="pos",
                 **along0)
    cs += _unary("jnp.cumsum", PL.FP32["jnp.cumsum"], **along0)
    cs += _unary("jnp.prod", PL.FP32["jnp.prod"], domain="pos")
    cs += _unary("jnp.sum", PL.FP32["jnp.sum"])
    cs += _unary("jnp.mean", PL.FP32["jnp.mean"])
    for k in ("jnp.var", "jnp.std"):
        cs += _unary(k, PL.FP32[k], j=lambda f, x: f(x, ddof=0),
                     t=lambda f, x: f(x, correction=0))
    cs += _unary("lax.exp", PL.FP32["lax.exp"])
    cs += _unary("lax.log", PL.FP32["lax.log"], domain="pos")
    cs += _unary("lax.log1p", PL.FP32["lax.log1p"], domain="pos")
    cs += _binary("lax.pow", PL.FP32["lax.pow"], domain="pos")
    cs += _unary("lax.rsqrt", PL.FP32["lax.rsqrt"], domain="pos")
    for k in ("lax.logistic", "lax.erf", "lax.erfc"):
        cs += _unary(k, PL.FP32[k])
    cs += _unary("lax.erf_inv", PL.FP32["lax.erf_inv"], domain="unit")
    last = dict(j=lambda f, x: f(x, axis=-1), t=lambda f, x: f(x, dim=-1))
    for k in ("nn.softmax", "nn.log_softmax", "nn.logsumexp"):
        cs += _unary(k, PL.FP32[k], **last)
    cs += _unary("nn.softplus", PL.FP32["nn.softplus"])
    cs += _unary("linalg.norm", PL.FP32["linalg.norm"])
    # --- promote -----------------------------------------------------------
    for k, ports in PL.CASTS.items():
        cs += _binary(k, ports, domain="pos" if "divide" in k else "any")
    # --- sequence promote --------------------------------------------------
    for k, ports in PL.SEQUENCE_CASTS.items():
        cs += [_case(k, p, [(3, 4), (3, 4)],
                     lambda f, a, b: f([a, b])) for p in ports]
    return cs


CASES = _cases()
CASE_IDS = [f"{c['key']}-{getattr(c['port'], '__name__', c['port'])}-{i}"
            for i, c in enumerate(CASES)]


def _inputs(shapes, domain, seed):
    rng = np.random.default_rng(seed)
    if domain == "pos":
        return [rng.uniform(0.5, 2.0, s).astype(np.float32) for s in shapes]
    if domain == "unit":
        return [rng.uniform(-0.9, 0.9, s).astype(np.float32) for s in shapes]
    return [(0.5 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _mixes(n):
    """Input dtypes: all low precision, all fp32, the first fp32 and the
    rest low precision ("low" / "f32" per input)."""
    mixes = [("low",) * n, ("f32",) * n]
    if n > 1:
        mixes.append(("f32",) + ("low",) * (n - 1))
    return mixes


def _pair(arrays, mix, jlow, tlow):
    js = [jnp.asarray(a).astype(jlow) if m == "low" else jnp.asarray(a)
          for a, m in zip(arrays, mix)]
    ts = [torch.from_numpy(a).to(tlow) if m == "low" else torch.from_numpy(a)
          for a, m in zip(arrays, mix)]
    return js, ts


def _same(jout, tout, tol, what):
    jd = str(jnp.dtype(jout.dtype))
    assert tout.dtype == _TDT[jd], f"{what}: port {tout.dtype}, jax {jd}"
    ref = np.asarray(jout).astype(np.float64)
    got = tout.double().numpy()
    assert got.shape == ref.shape, f"{what}: {got.shape} vs {ref.shape}"
    err = np.abs(got - ref)
    lim = tol * np.maximum(1.0, np.abs(ref))
    assert (err <= lim).all(), f"{what}: max err {err.max():.3g}"


@pytest.mark.parametrize("low", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_op_table_matches_jax(case, low):
    jlow, tlow, tol = LOW[low]
    arrays = _inputs(case["shapes"], case["domain"], seed=len(CASE_IDS))
    for mix in _mixes(len(arrays)):
        js, ts = _pair(arrays, mix, jlow, tlow)
        with jamp_mod.autocast(jlow):
            jout = case["j"](_jfn(case["key"]), *js)
        with amp.autocast(tlow):
            tout = case["t"](case["port"], *ts)
        _same(jout, tout, tol, f"{case['key']} {mix}")
    assert not _get_current_function_mode_stack()


# method and operator forms: (JAX list entry, jax form, port form, shapes,
# domain); neither package casts them
_M = [
    ("jnp.matmul", lambda a, b: a @ b, lambda a, b: a @ b,
     ((4, 8), (8, 3)), "any"),
    ("jnp.dot", lambda a, b: a.dot(b), lambda a, b: a.dot(b),
     ((16,), (16,)), "any"),
    ("jnp.sum", lambda x: x.sum(), lambda x: x.sum(), ((4, 6),), "any"),
    ("jnp.prod", lambda x: x.prod(), lambda x: x.prod(), ((4, 6),), "pos"),
    ("jnp.mean", lambda x: x.mean(), lambda x: x.mean(), ((4, 6),), "any"),
    ("jnp.var", lambda x: x.var(), lambda x: x.var(correction=0),
     ((4, 6),), "any"),
    ("jnp.std", lambda x: x.std(), lambda x: x.std(correction=0),
     ((4, 6),), "any"),
    ("jnp.cumsum", lambda x: x.cumsum(axis=0), lambda x: x.cumsum(0),
     ((4, 6),), "any"),
    ("jnp.cumprod", lambda x: x.cumprod(axis=0), lambda x: x.cumprod(0),
     ((4, 6),), "pos"),
    ("jnp.add", lambda a, b: a + b, lambda a, b: a + b, ((4, 6),) * 2,
     "any"),
    ("jnp.subtract", lambda a, b: a - b, lambda a, b: a - b,
     ((4, 6),) * 2, "any"),
    ("jnp.multiply", lambda a, b: a * b, lambda a, b: a * b,
     ((4, 6),) * 2, "any"),
    ("jnp.divide", lambda a, b: a / b, lambda a, b: a / b, ((4, 6),) * 2,
     "pos"),
    ("jnp.equal", lambda a, b: a == b, lambda a, b: a == b,
     ((4, 6),) * 2, "any"),
    ("jnp.greater", lambda a, b: a > b, lambda a, b: a > b,
     ((4, 6),) * 2, "any"),
    ("jnp.greater_equal", lambda a, b: a >= b, lambda a, b: a >= b,
     ((4, 6),) * 2, "any"),
    ("jnp.less", lambda a, b: a < b, lambda a, b: a < b, ((4, 6),) * 2,
     "any"),
    ("jnp.less_equal", lambda a, b: a <= b, lambda a, b: a <= b,
     ((4, 6),) * 2, "any"),
    ("jnp.not_equal", lambda a, b: a != b, lambda a, b: a != b,
     ((4, 6),) * 2, "any"),
]


@pytest.mark.parametrize("low", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", _M, ids=[m[0] for m in _M])
def test_method_and_operator_forms_match_jax(case, low):
    """Uncast in both: an all-fp32 product stays fp32, a low-precision
    reduction stays low precision.  Mixed dtypes only where torch's own
    promotion defines the operator (its products need one dtype)."""
    key, jf, tf, shapes, domain = case
    jlow, tlow, tol = LOW[low]
    arrays = _inputs(shapes, domain, seed=7)
    mixes = [("low",) * len(shapes), ("f32",) * len(shapes)]
    if len(shapes) == 2 and key not in ("jnp.matmul", "jnp.dot"):
        mixes.append(("f32", "low"))
    for mix in mixes:
        js, ts = _pair(arrays, mix, jlow, tlow)
        with jamp_mod.autocast(jlow):
            jout = jf(*js)
        with amp.autocast(tlow):
            tout = tf(*ts)
        _same(jout, tout, tol, f"{key} {mix}")
        if mix[0] == "f32" and key == "jnp.matmul":
            assert tout.dtype == torch.float32      # not cast


_JAX_LISTS = {
    "LOW_PREC": (("jnp", JL.JNP_LOW_PREC), ("lax", JL.LAX_LOW_PREC),
                 ("nn", JL.NN_LOW_PREC)),
    "FP32": (("jnp", JL.JNP_FP32), ("lax", JL.LAX_FP32),
             ("nn", JL.NN_FP32), ("linalg", JL.LINALG_FP32)),
    "CASTS": (("jnp", JL.JNP_CASTS),),
    "SEQUENCE_CASTS": (("jnp", JL.JNP_SEQUENCE_CASTS),),
}


@pytest.mark.parametrize("category", sorted(_JAX_LISTS))
def test_every_jax_list_entry_has_a_counterpart(category):
    jax_names = {f"{ns}.{name}" for ns, names in _JAX_LISTS[category]
                 for name in names}
    port = getattr(PL, category)
    missing = jax_names - set(port)
    assert not missing, f"JAX {category} entries with no port counterpart: "\
        f"{sorted(missing)}"
    assert set(port) == jax_names
    assert all(port[k] for k in port)
    # the op table drives each entry and each of its spellings
    driven = {(c["key"], c["port"]) for c in CASES}
    for k, fns in port.items():
        for f in fns:
            assert (k, f) in driven, f"no op-table case for {k} -> {f}"


def test_banned_and_bf16_lists_mirror_jax():
    """The JAX package's bf16 lists are its fp16 lists (the port keeps
    one), and neither package bans anything by default."""
    assert JL.JNP_LOW_PREC_BF16 == JL.JNP_LOW_PREC
    assert JL.LAX_LOW_PREC_BF16 == JL.LAX_LOW_PREC
    assert list(JL.BANNED_FUNCS) == [] and list(PL.BANNED_FUNCS) == []


def test_banned_mechanism_raises(monkeypatch):
    monkeypatch.setattr(PL, "BANNED_FUNCS",
                        [(torch.tanh, "use the sigmoid form")])
    with amp.autocast(torch.float16):
        with pytest.raises(RuntimeError, match="use the sigmoid form"):
            torch.tanh(torch.ones(2))
    amp.init(torch.float16, allow_banned=True)
    assert torch.tanh(torch.ones(2)).dtype == torch.float32
    amp.uninit()


def test_casts_reach_the_kwargs_and_skip_non_floats():
    x = torch.ones(3, 4)
    with amp.autocast(torch.bfloat16):
        out = F.linear(x, weight=torch.ones(5, 4), bias=torch.ones(5))
        idx = torch.add(torch.arange(3), 2)
        half = torch.add(torch.ones(3, dtype=torch.bfloat16), 2.0)
    assert out.dtype == torch.bfloat16
    assert idx.dtype == torch.int64
    assert half.dtype == torch.bfloat16       # a Python scalar passes


# --- tests/L0/test_amp.py, test by test -------------------------------------

@pytest.mark.parametrize("ptype", [torch.float16, torch.bfloat16])
def test_autocast_matmul_low_precision(ptype):
    with amp_mod.autocast(ptype):
        out = torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert out.dtype == ptype


@pytest.mark.parametrize("ptype", [torch.float16, torch.bfloat16])
def test_autocast_fp32_funcs(ptype):
    with amp_mod.autocast(ptype):
        x = torch.ones(8, 8, dtype=ptype)
        out = torch.exp(x)
        s = torch.sum(x)
    assert out.dtype == torch.float32 and s.dtype == torch.float32


def test_promotion_widest_type():
    with amp_mod.autocast(torch.bfloat16):
        a = torch.ones(4, dtype=torch.bfloat16)
        b = torch.ones(4)
        out = torch.add(a, b)
        cat = torch.cat([a, b])
    assert out.dtype == torch.float32 and cat.dtype == torch.float32


def test_autocast_restores_cleanly():
    with amp_mod.autocast(torch.bfloat16):
        assert len(_get_current_function_mode_stack()) == 1
        with amp_mod.autocast(torch.float16):          # nested: fp16 inside
            assert torch.matmul(torch.ones(2, 2),
                                torch.ones(2, 2)).dtype == torch.float16
        assert torch.matmul(torch.ones(2, 2),
                            torch.ones(2, 2)).dtype == torch.bfloat16
    assert not _get_current_function_mode_stack()
    assert not amp.is_initialized()
    out = torch.matmul(torch.ones(2, 2), torch.ones(2, 2))
    assert out.dtype == torch.float32


def test_decorators():
    @amp.half_function
    def f(x):
        return x * 2

    @amp.float_function
    def g(x):
        return x * 3

    @amp.promote_function
    def h(a, b):
        return a * b

    with amp_mod.autocast(torch.bfloat16):
        assert f(torch.ones(4)).dtype == torch.bfloat16
        assert g(torch.ones(4, dtype=torch.bfloat16)).dtype == torch.float32
        assert h(torch.ones(4, dtype=torch.bfloat16),
                 torch.ones(4)).dtype == torch.float32
    assert f(torch.ones(4)).dtype == torch.float32      # no-op when off
    with jamp_mod.autocast(jnp.bfloat16):               # as the JAX ones
        assert jamp.half_function(lambda x: x * 2)(
            jnp.ones((4,))).dtype == jnp.bfloat16


def test_disable_casts():
    amp.init(torch.bfloat16)
    with amp.disable_casts():
        assert not amp.is_initialized()
        assert torch.matmul(torch.ones(2, 2),
                            torch.ones(2, 2)).dtype == torch.float32
    assert amp.is_initialized()
    assert torch.matmul(torch.ones(2, 2),
                        torch.ones(2, 2)).dtype == torch.bfloat16
    amp.uninit()
    assert not _get_current_function_mode_stack()


class _UserOps:
    """A module of the user's whose functions are registered."""

    @staticmethod
    def scale(x):
        return x * 2

    @staticmethod
    def norm(x):
        return x / 3

    @staticmethod
    def mix(a, b):
        return a + b


def test_user_registration_patches_at_init(monkeypatch):
    monkeypatch.setattr(amp_mod, "_user_cast_entries", [])
    jmod = type("JaxUserOps", (), {k: staticmethod(v) for k, v in
                                   vars(_UserOps).items()
                                   if isinstance(v, staticmethod)})
    monkeypatch.setattr(jamp_mod, "_user_cast_entries", [])
    orig = _UserOps.scale
    for reg, jreg, name in (
            (amp.register_half_function, jamp.register_half_function,
             "scale"),
            (amp.register_float_function, jamp.register_float_function,
             "norm"),
            (amp.register_promote_function, jamp.register_promote_function,
             "mix")):
        reg(_UserOps, name)
        jreg(jmod, name)
    with amp.autocast(torch.bfloat16):
        assert _UserOps.scale is not orig
        s = _UserOps.scale(torch.ones(4))
        n = _UserOps.norm(torch.ones(4, dtype=torch.bfloat16))
        m = _UserOps.mix(torch.ones(4, dtype=torch.bfloat16), torch.ones(4))
    with jamp_mod.autocast(jnp.bfloat16):
        js = jmod.scale(jnp.ones((4,)))
        jn = jmod.norm(jnp.ones((4,), jnp.bfloat16))
        jm = jmod.mix(jnp.ones((4,), jnp.bfloat16), jnp.ones((4,)))
    assert _UserOps.scale is orig                       # restored
    for got, ref in ((s, js), (n, jn), (m, jm)):
        assert got.dtype == _TDT[str(jnp.dtype(ref.dtype))]
    # a registered name the lists already hold keeps its list's cast
    amp.register_float_function(torch, "matmul")
    with amp.autocast(torch.float16):
        assert torch.matmul(torch.ones(2, 2),
                            torch.ones(2, 2)).dtype == torch.float16


def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (0.1 * rng.standard_normal((16, 32))).astype(np.float32),
            "b1": np.zeros(32, np.float32),
            "w2": (0.1 * rng.standard_normal((32, 4))).astype(np.float32),
            "b2": np.zeros(4, np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_amp_state_dict_roundtrip():
    p = _t(_toy_params())
    st = amp.initialize(p, opt_level="O2", num_losses=3, verbosity=0)
    st = st._replace(scalers=tuple(
        amp.scaler.update(s, torch.tensor(False)) for s in st.scalers))
    d = amp.state_dict(st)
    assert len(d) == 3 and d["loss_scaler1"]["loss_scale"] == 2.0 ** 15
    st2 = amp.initialize(p, opt_level="O2", num_losses=3, verbosity=0)
    st2 = amp.load_state_dict(st2, d)
    for a, b in zip(st.scalers, st2.scalers):
        assert float(a.loss_scale) == float(b.loss_scale)
        assert int(a.unskipped) == int(b.unskipped)
    # the JAX package's dict loads into the port and back
    js = jamp.initialize(jax.tree_util.tree_map(jnp.asarray,
                                                _toy_params()),
                         opt_level="O2", num_losses=3, verbosity=0)
    js = jamp.load_state_dict(js, d)
    assert jamp.state_dict(js) == d
    assert amp.state_dict(amp.load_state_dict(st2, jamp.state_dict(js))) \
        == d


def test_cast_model_outputs():
    p = {"w": torch.ones(4, 4)}
    st = amp.initialize(p, FusedSGD(lr=0.1), opt_level="O5", verbosity=0,
                        cast_model_outputs=torch.float32)
    out = {"logits": torch.ones(2, dtype=torch.bfloat16),
           "ids": torch.zeros(2, dtype=torch.int32), "aux_loss": 0.5}
    cast = st.cast_output(out)
    assert cast["logits"].dtype == torch.float32
    assert cast["ids"].dtype == torch.int32
    assert cast["aux_loss"] == 0.5
    st2 = amp.add_param_group(st, {"w2": torch.ones(2, 2)})
    assert st2.cast_model_outputs == torch.float32
    st3 = amp.initialize(p, FusedSGD(lr=0.1), opt_level="O5", verbosity=0)
    assert st3.cast_output(out)["logits"].dtype == torch.bfloat16
    assert st3.cast_input(torch.ones(2)).dtype == torch.bfloat16


def test_initialize_list_of_models():
    mA = {"w": torch.ones(4, 4)}
    mB = {"w": torch.ones(2, 2), "b": torch.zeros(2)}
    states = amp.initialize([mA, mB], [FusedAdam(lr=1e-3),
                                       FusedSGD(lr=0.1)],
                            opt_level="O2", verbosity=0)
    assert isinstance(states, list) and len(states) == 2
    assert states[0].model_params["w"].dtype == torch.float16
    assert states[1].master_params["b"].dtype == torch.float32
    bad = tree_map(lambda p: torch.full_like(p, float("inf")),
                   states[0].master_params)
    s0 = amp.amp_step(states[0], bad)
    assert float(s0.scalers[0].loss_scale) == 2.0 ** 15
    assert float(states[1].scalers[0].loss_scale) == 2.0 ** 16
    with pytest.raises(ValueError, match="models but"):
        amp.initialize([mA, mB], [FusedAdam(lr=1e-3)], opt_level="O2",
                       verbosity=0)
    st = amp.initialize([{"w": torch.ones(2, 2)}], FusedAdam(lr=1e-3),
                        opt_level="O0", verbosity=0)
    assert not isinstance(st, list)


def test_legacy_amp_handle_flow():
    h = amp.init_handle(loss_scale="dynamic", device="cpu")
    s0 = h.loss_scale
    assert float(h.scale_loss(torch.tensor(2.0))) == 2.0 * s0
    g32, skip = h.unscale_and_update({"w": torch.ones(4) * s0})
    assert not skip
    torch.testing.assert_close(g32["w"], torch.ones(4))
    _, skip = h.unscale_and_update({"w": torch.full((4,), float("inf"))})
    assert skip and h.loss_scale == s0 / 2
    h2 = amp.init_handle(device="cpu")
    h2.load_state_dict(h.state_dict())
    assert h2.loss_scale == h.loss_scale
    # the JAX handle walks the same scales
    jh = jamp.init_handle(loss_scale="dynamic")
    jh.unscale_and_update({"w": jnp.full((4,), jnp.inf)})
    assert jh.loss_scale == h.loss_scale
    nh = amp.init_handle(enabled=False)
    assert isinstance(nh, amp.NoOpHandle)
    assert float(nh.scale_loss(torch.tensor(2.0))) == 2.0
    _, skip = nh.unscale_and_update({"w": torch.full((4,), float("inf"))})
    assert not skip


def test_legacy_optim_wrapper_multi_loss():
    h = amp.init_handle(device="cpu")
    opt = h.wrap_optimizer(FusedSGD(lr=0.1), num_loss=2)
    with pytest.raises(RuntimeError):
        h.scale_loss(torch.tensor(1.0))
    s0, s1 = opt.loss_scale(0), opt.loss_scale(1)
    _, skip0 = opt.unscale_and_update({"w": torch.ones(4) * s0}, 0)
    _, skip1 = opt.unscale_and_update({"w": torch.full((4,), float("inf"))},
                                      1)
    assert not skip0 and skip1
    assert opt.loss_scale(1) == s1 / 2 and opt.loss_scale(0) >= s0
    assert opt.lr == 0.1


def test_loss_scaler_facade():
    ls = amp.LossScaler(device="cpu")
    assert ls.loss_scale() == 2.0 ** 16
    assert ls.update_scale(torch.tensor(False))        # skip
    assert ls.loss_scale() == 2.0 ** 15
    ls2 = amp.LossScaler(device="cpu")
    ls2.load_state_dict(ls.state_dict())
    assert ls2.loss_scale() == 2.0 ** 15 and ls2.state.scale == 2.0 ** 15


def test_amp_exports_every_jax_name():
    names = [n for n in dir(jamp) if not n.startswith("_")
             and n not in ("amp", "frontend", "handle", "properties",
                           "wrap", "lists")]
    missing = [n for n in names if not hasattr(amp, n)]
    assert not missing, missing


# --- tests/L0/test_add_param_group.py ---------------------------------------

def _group_a():
    rng = np.random.default_rng(0)
    return {"wa": (0.5 * rng.standard_normal((16, 8))).astype(np.float32),
            "ba": np.zeros(8, np.float32)}


def _group_b():
    rng = np.random.default_rng(1)
    return {"wb": (0.5 * rng.standard_normal((8, 4))).astype(np.float32)}


def _jstep(state, loss_fn, x):
    def f(p):
        p32 = jax.tree_util.tree_map(lambda t: t.astype(jnp.float32), p)
        return jamp.scale_loss(loss_fn(p32, x), state)
    grads = jax.grad(f)(state.model_params)
    return jamp.amp_step(state, grads)


def _pstep(state, loss_fn, x):
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state.model_params)]
    keys = sorted(state.model_params)
    p32 = {k: p.float() for k, p in zip(keys, leaves)}
    g = torch.autograd.grad(amp.scale_loss(loss_fn(p32, x), state), leaves)
    return amp.amp_step(state, {k: gi for k, gi in zip(keys, g)})


def _jloss_a(p, x):
    return jnp.mean((x @ p["wa"] + p["ba"]) ** 2)


def _ploss_a(p, x):
    return ((x @ p["wa"] + p["ba"]) ** 2).mean()


def _jloss_ab(p, x):
    return jnp.mean(((x @ p["wa"] + p["ba"]) @ p["wb"]) ** 2)


def _ploss_ab(p, x):
    return (((x @ p["wa"] + p["ba"]) @ p["wb"]) ** 2).mean()


def _moments(state):
    m = state.opt_state.m
    if isinstance(m, dict):
        return m
    fl = state.optimizer.flattener_for(tree_map(
        lambda p: torch.empty(p.shape, device="meta"),
        state.params_for_eval()))
    return fl.unflatten(m, dtype=torch.float32)


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("opt_level", ["O2", "O5"])
def test_add_param_group_preserves_state(impl, opt_level):
    """Both packages extend the group mid-run the same way: old values,
    moments and step count carried, new leaves at the preset's dtype with
    zero moments, and 3 more steps over both groups agree (fp16 / bf16
    model copies: within 1e-2 of the largest value)."""
    x = np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32)
    js = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, _group_a()),
                         JaxAdam(lr=1e-2, impl=impl), opt_level=opt_level,
                         verbosity=0)
    ps = amp.initialize(_t(_group_a()), FusedAdam(lr=1e-2, impl=impl),
                        opt_level=opt_level, verbosity=0)
    for _ in range(3):
        js = _jstep(js, _jloss_a, jnp.asarray(x))
        ps = _pstep(ps, _ploss_a, torch.from_numpy(x))
    before32 = ps.params_for_eval()
    before_m = _moments(ps)
    count = int(ps.opt_state.count)

    ps2 = amp.add_param_group(ps, _t(_group_b()))
    js2 = jamp.add_param_group(js, jax.tree_util.tree_map(jnp.asarray,
                                                          _group_b()))
    after32 = ps2.params_for_eval()
    assert set(after32) == {"wa", "ba", "wb"}
    for k in ("wa", "ba"):
        torch.testing.assert_close(before32[k], after32[k], rtol=0, atol=0)
    after_m = _moments(ps2)
    for k in ("wa", "ba"):
        torch.testing.assert_close(before_m[k], after_m[k], rtol=0, atol=0)
    assert float(after_m["wb"].abs().max()) == 0.0
    assert int(ps2.opt_state.count) == count == int(js2.opt_state.count)
    model_dt = {"O2": torch.float16, "O5": torch.bfloat16}[opt_level]
    assert ps2.model_params["wb"].dtype == model_dt

    wb0 = after32["wb"].clone()
    for _ in range(3):
        js2 = _jstep(js2, _jloss_ab, jnp.asarray(x))
        ps2 = _pstep(ps2, _ploss_ab, torch.from_numpy(x))
    assert float((ps2.params_for_eval()["wb"] - wb0).abs().max()) > 0
    for k, v in js2.params_for_eval().items():
        ref = np.asarray(v)
        got = ps2.params_for_eval()[k].numpy()
        assert np.abs(got - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())


def test_add_param_group_keeps_scaler_state():
    st = amp.initialize(_t(_group_a()), FusedAdam(lr=1e-2), opt_level="O2",
                        verbosity=0)
    bad = tree_map(lambda g: torch.full_like(g, float("inf")),
                   st.master_params)
    st = amp.amp_step(st, bad)
    s = float(st.scalers[0].scale)
    assert s == 65536.0 / 2
    st2 = amp.add_param_group(st, _t(_group_b()))
    assert float(st2.scalers[0].scale) == s


def test_add_param_group_rejects_key_collisions():
    st = amp.initialize(_t(_group_a()), FusedAdam(lr=1e-2), opt_level="O0",
                        verbosity=0)
    with pytest.raises(ValueError, match="re-uses"):
        amp.add_param_group(st, {"wa": torch.zeros(2, 2)})
