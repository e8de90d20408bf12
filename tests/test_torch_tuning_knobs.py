"""The tuning profile's knob reads and environment overrides in the port
against the JAX package's, site by site.

Every ``tuning.get_on_tpu`` site of the JAX package has a table of cases
(an explicit argument, an environment override, a profile value, none of
them, and their mixes).  Both packages read one profile file and one
environment; the JAX package's TPU is faked as ``tests/L0/test_tuning.py``
fakes it (``jax.default_backend`` reads "tpu" after the CPU backend came
up), the port's card by patching ``tuning._cuda_initialized``.  Each case
gives the same decision from the JAX resolver and from the port's, a
raise included.  Off the device, with the profile present, the port gives
its built-in.

Two built-ins differ by design: where nothing but the built-in decides,
the JAX layer norm and MLP take their XLA routes and the port takes its
kernels (the port's rule that a TPU kernel on the path becomes the card's
kernel); the tables say so case by case.

The flash block keys and pins (``flash_block_*``, ``APEX_TPU_FLASH_BLOCK_*``,
``APEX_TPU_FLASH_VMEM_MB``) size the JAX package's Pallas blocks; the CUDA
kernels' tiles are fixed, so the port reads none of them: a profile and an
environment that hold them change no decision, no output bit and no
tuning read (the card's launches: ``tests/test_torch_cuda_kernels.py``).
"""
import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.multihead_attn import flash as jflash
from apex_tpu.contrib.optimizers import distributed_fused as jdf
from apex_tpu.contrib.xentropy import softmax_xentropy as jx
from apex_tpu.mlp import mlp as jmlp
from apex_tpu.models import transformer as jtr
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.parallel import collectives as jcoll
from apex_tpu.parallel import overlap as jov
from apex_tpu.parallel import weight_update as jwu
from apex_tpu.utils import tuning as jtuning

from apex_tpu_torch.contrib.multihead_attn import flash as pflash
from apex_tpu_torch.contrib.optimizers import distributed_fused as pdf
from apex_tpu_torch.contrib.xentropy import softmax_xentropy as px
from apex_tpu_torch.mlp import mlp as pmlp
from apex_tpu_torch.models import transformer as ptr
from apex_tpu_torch.optimizers import FusedAdam as PFusedAdam
from apex_tpu_torch.parallel import collectives as pcoll
from apex_tpu_torch.parallel import overlap as pov
from apex_tpu_torch.parallel import weight_update as pwu
from apex_tpu_torch.utils import build, tuning

from _torch_port import amp_uninit  # noqa: F401  (autouse)

# the packages re-export functions of these modules' names
jfln = importlib.import_module("apex_tpu.normalization.fused_layer_norm")
pfln = importlib.import_module(
    "apex_tpu_torch.normalization.fused_layer_norm")

ENV_KNOBS = ("APEX_TPU_FLASH_BWD_IMPL", "APEX_TPU_FLASH_BWD_FUSE",
             "APEX_TPU_FLASH_BWD_FUSE_MB", "APEX_TPU_XENT_IMPL",
             "APEX_TPU_COLLECTIVES", "APEX_TPU_OVERLAP",
             "APEX_TPU_UPDATE_SHARDING", "APEX_TPU_FLASH_BLOCK_Q",
             "APEX_TPU_FLASH_BLOCK_K", "APEX_TPU_FLASH_VMEM_MB",
             "APEX_TPU_FLASH_BWD_BLOCK_Q", "APEX_TPU_FLASH_BWD_BLOCK_K",
             "APEX_TPU_FLASH_BWD_DQ_BLOCK_Q", "APEX_TPU_FLASH_BWD_DQ_BLOCK_K",
             "APEX_TPU_FLASH_BWD_DKV_BLOCK_Q",
             "APEX_TPU_FLASH_BWD_DKV_BLOCK_K")


@pytest.fixture
def knobs(tmp_path, monkeypatch):
    """``set(profile, env, on_device)``: one profile file and one
    environment for both packages, each package's device faked or not."""
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("APEX_TPU_TUNING_FILE", str(path))
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    jax.devices()                       # backends_initialized() for JAX

    def set_(profile, env, on_device):
        path.write_text(json.dumps(profile))
        tuning.reload()
        jtuning.reload()
        for k in ENV_KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(jax, "default_backend",
                            (lambda: "tpu") if on_device else (lambda: "cpu"))
        monkeypatch.setattr(tuning, "_cuda_initialized", lambda: on_device)

    yield set_
    tuning.reload()
    jtuning.reload()


def _decide(fn):
    """The decision ``fn`` takes, or the exception class it raises."""
    try:
        return fn()
    except (ValueError, jcoll.CollectiveError, pcoll.CollectiveError) as e:
        return type(e).__name__


def _cases(rows):
    """(arg, env, profile) rows, each on and off the device."""
    return [pytest.param(arg, env, prof, dev,
                         id=f"{i}-{'dev' if dev else 'cpu'}")
            for i, (arg, env, prof) in enumerate(rows)
            for dev in (True, False)]


# -- flash: the backward route ----------------------------------------------

BWD_IMPL_ROWS = [
    ("auto", {}, {}),
    ("auto", {}, {"flash_bwd_impl": "xla"}),
    ("auto", {}, {"flash_bwd_impl": "pallas"}),
    ("auto", {"APEX_TPU_FLASH_BWD_IMPL": "xla"}, {}),
    ("auto", {"APEX_TPU_FLASH_BWD_IMPL": "pallas"},
     {"flash_bwd_impl": "xla"}),
    ("auto", {"APEX_TPU_FLASH_BWD_IMPL": "bogus"},
     {"flash_bwd_impl": "xla"}),
    ("pallas", {"APEX_TPU_FLASH_BWD_IMPL": "xla"},
     {"flash_bwd_impl": "xla"}),
    ("xla", {}, {"flash_bwd_impl": "pallas"}),
    ("triton", {}, {}),
]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(BWD_IMPL_ROWS))
def test_flash_backward_route_matches_jax(knobs, arg, env, prof, dev):
    knobs(prof, env, dev)
    j = _decide(lambda: jflash._resolve_backward(arg))
    p = _decide(lambda: pflash._resolve_backward(arg))
    assert p == j
    if not dev and arg == "auto" and "APEX_TPU_FLASH_BWD_IMPL" not in env:
        assert p == "pallas"                 # the built-in, off the card


def test_flash_backward_amp_default_sits_between_env_and_profile(knobs):
    for dev in (True, False):
        knobs({"flash_bwd_impl": "pallas"}, {}, dev)
        try:
            jflash.set_default_backward("xla")
            pflash.set_default_backward("xla")
            assert pflash._resolve_backward("auto") == \
                jflash._resolve_backward("auto") == "xla"
            knobs({"flash_bwd_impl": "pallas"},
                  {"APEX_TPU_FLASH_BWD_IMPL": "pallas"}, dev)
            assert pflash._resolve_backward("auto") == \
                jflash._resolve_backward("auto") == "pallas"
        finally:
            jflash.set_default_backward("auto")
            pflash.set_default_backward("auto")


# -- flash: fused or split ---------------------------------------------------

FUSE_SHAPES = [(128, 512, 512, 64), (64, 4096, 4096, 64),
               (128, 2048, 2048, 64), (128, 2048, 2049, 64)]
FUSE_ROWS = [
    (None, {}, {}),
    (None, {}, {"flash_bwd_fuse": False}),
    (None, {}, {"flash_bwd_fuse": True}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": "1"}, {"flash_bwd_fuse": False}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": "yes"}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": "0"}, {"flash_bwd_fuse": True}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": "off"}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": "False"}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": "no"}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE": ""}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE_MB": "1"}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE_MB": "100000"}, {}),
    (None, {"APEX_TPU_FLASH_BWD_FUSE_MB": "1"}, {"flash_bwd_fuse": True}),
    (True, {"APEX_TPU_FLASH_BWD_FUSE": "0"}, {"flash_bwd_fuse": False}),
    (False, {"APEX_TPU_FLASH_BWD_FUSE": "1"}, {"flash_bwd_fuse": True}),
]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(FUSE_ROWS))
def test_flash_fuse_matches_jax(knobs, arg, env, prof, dev):
    """The JAX rule at its default 128-key backward block, which the
    port's fixed 128-key tiles count alike."""
    knobs(prof, env, dev)
    for shape in FUSE_SHAPES:
        j = jflash._resolve_fuse(arg, *shape, 128)
        p = pflash._resolve_fuse(arg, *shape)
        assert p == j, shape
        if not dev and arg is None and not env:
            assert p == pflash._resolve_fuse(None, *shape) \
                == (shape[0] * -(-shape[2] // 128) * shape[1] * shape[3] * 4
                    <= 2 ** 30)


# -- the cross-entropy's impl="auto" -----------------------------------------

XENT_ROWS = [
    ("auto", {}, {}),
    ("auto", {}, {"xent_auto_impl": "xla"}),
    ("auto", {}, {"xent_auto_impl": "pallas"}),
    ("auto", {"APEX_TPU_XENT_IMPL": "xla"}, {"xent_auto_impl": "pallas"}),
    ("auto", {"APEX_TPU_XENT_IMPL": "pallas"}, {"xent_auto_impl": "xla"}),
    ("auto", {"APEX_TPU_XENT_IMPL": "other"}, {}),
    ("auto", {"APEX_TPU_XENT_IMPL": ""}, {"xent_auto_impl": "xla"}),
    ("pallas", {"APEX_TPU_XENT_IMPL": "xla"}, {"xent_auto_impl": "xla"}),
    ("xla", {"APEX_TPU_XENT_IMPL": "pallas"}, {}),
]


def _jax_xent_route(monkeypatch, impl):
    """The route the JAX ``_fwd`` takes for ``impl``: its two forwards
    replaced by recorders."""
    seen = []
    monkeypatch.setattr(jx, "_xent_fwd_pallas",
                        lambda *a: seen.append("pallas") or (None, None))
    monkeypatch.setattr(jx, "_xent_fwd_xla",
                        lambda *a: seen.append("xla") or (None, None))
    jx._fwd(jnp.zeros((2, 8)), jnp.zeros((2,), jnp.int32), 0.0, impl)
    return seen[0]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(XENT_ROWS))
def test_xent_route_matches_jax(knobs, monkeypatch, arg, env, prof, dev):
    knobs(prof, env, dev)
    j = _jax_xent_route(monkeypatch, arg)
    # the JAX built-in asks its backend; the port's, the logits' device
    p = px._resolve_impl(arg, "cuda" if dev else "cpu")
    assert p == j
    if not dev and arg == "auto" and not env:
        assert p == "xla"                    # a CPU tensor: plain version


def test_xent_route_reaches_the_forward(knobs, monkeypatch):
    """The resolved route is the forward that runs: on a CPU tensor the
    plain forward either way, and ``_xent_fwd`` only for "pallas"."""
    seen = []
    real = px._xent_fwd
    monkeypatch.setattr(px, "_xent_fwd",
                        lambda *a: seen.append("kernel") or real(*a))
    x = torch.randn(4, 16)
    y = torch.tensor([1, 2, 3, 4])
    for env, want in (({"APEX_TPU_XENT_IMPL": "pallas"}, ["kernel"]),
                      ({"APEX_TPU_XENT_IMPL": "xla"}, []), ({}, [])):
        knobs({"xent_auto_impl": "pallas"}, env, False)
        seen.clear()
        px.softmax_xentropy_loss(x, y, 0.0, -1)
        assert seen == want, env


# -- layer norm and MLP: use_pallas=None -------------------------------------

USE_PALLAS_ROWS = [(None, {}, {}), (None, {}, {"K": False}),
                   (None, {}, {"K": True}), (True, {}, {"K": False}),
                   (False, {}, {"K": True})]


def _ln_rows():
    return [(a, e, {("layer_norm_use_pallas" if k == "K" else k): v
                    for k, v in p.items()}) for a, e, p in USE_PALLAS_ROWS]


def _jax_ln_route(monkeypatch, use_pallas):
    import apex_tpu.ops.layer_norm as jln
    seen = []
    monkeypatch.setattr(jln, "layer_norm_pallas",
                        lambda *a: seen.append(True))
    monkeypatch.setattr(jfln, "_fused_layer_norm_affine_xla",
                        lambda *a: seen.append(False))
    jfln.fused_layer_norm_affine(jnp.zeros((2, 8)), jnp.ones(8),
                                 jnp.zeros(8), 8, use_pallas=use_pallas)
    return seen[0]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(_ln_rows()))
def test_layer_norm_route_matches_jax(knobs, monkeypatch, arg, env, prof,
                                      dev):
    knobs(prof, env, dev)
    j = _jax_ln_route(monkeypatch, arg)
    p = pfln._resolve_use_pallas(arg)
    if arg is None and not (dev and prof):
        # the built-in decides: the JAX XLA route, the port's kernels
        assert (j, p) == (False, True)
    else:
        assert p == j


@pytest.mark.parametrize("arg,env,prof,dev", _cases(
    [(a, e, {("mlp_use_pallas" if k == "K" else k): v for k, v in p.items()})
     for a, e, p in USE_PALLAS_ROWS]))
def test_mlp_route_matches_jax(knobs, arg, env, prof, dev):
    knobs(prof, env, dev)
    j = bool(jmlp.MLP([4, 8], use_pallas=arg).use_pallas)
    p = bool(pmlp.MLP([4, 8], use_pallas=arg).use_pallas)
    if arg is None and not (dev and prof):
        assert (j, p) == (False, True)     # the built-ins, as above
    else:
        assert p == j


@pytest.mark.parametrize("use_pallas", [True, False])
def test_layer_norm_routes_agree_and_only_one_reaches_the_kernel(
        use_pallas, monkeypatch):
    """``use_pallas=False`` is the JAX XLA VJP's counterpart: the plain
    forward and dx from the saved statistics, no kernel wrapper called;
    both routes give the JAX function's outputs and gradients."""
    import apex_tpu_torch.ops.layer_norm as pln
    calls = []
    for name in ("ln_fwd", "ln_bwd"):
        real = getattr(pln, name)
        monkeypatch.setattr(pln, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    g = rng.standard_normal((6, 4, 32)).astype(np.float32)

    def jloss(x, w, b):
        out = jfln.fused_layer_norm_affine(x, w, b, 32, use_pallas=False)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(x, w, b)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = pfln.fused_layer_norm_affine(tx, tw, tb, 32, use_pallas=use_pallas)
    grads = torch.autograd.grad(out, (tx, tw, tb), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    for a, ref in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)
    assert calls == (["ln_fwd", "ln_bwd"] if use_pallas else [])
    mod = pfln.FusedLayerNorm(32, use_pallas=use_pallas, device="cpu")
    calls.clear()
    mod(tx).sum().backward()
    assert calls == (["ln_fwd", "ln_bwd"] if use_pallas else [])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_mlp_routes_agree_and_only_one_reaches_the_kernel(use_pallas,
                                                          monkeypatch):
    """``MLP(use_pallas=False)`` is the JAX XLA chain's counterpart: the
    same outputs and gradients as the JAX MLP, no dense wrapper called."""
    import apex_tpu_torch.ops.fused_mlp as pfm
    calls = []
    real = pfm.fused_dense_act
    monkeypatch.setattr(pfm, "fused_dense_act",
                        lambda *a: calls.append(1) or real(*a))
    sizes = [16, 32, 8]
    jm = jmlp.MLP(sizes, use_pallas=False)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda p, x: jm.apply(p, x), params, x)
    jgp, jgx = jvjp(jnp.asarray(g))
    pm = pmlp.MLP(sizes, use_pallas=use_pallas)
    tp = pmlp.mlp_params_from_jax(params, device="cpu")
    leaves = tp["weights"] + tp["biases"]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = pm.apply(tp, tx)
    grads = torch.autograd.grad(out, leaves + [tx], torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    jleaves = list(jgp["weights"]) + list(jgp["biases"]) + [jgx]
    for a, ref in zip(grads, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
    assert (len(calls) == 2) == use_pallas and (not calls) != use_pallas


# -- bert_large_config's attention -------------------------------------------

ATTN_ROWS = [({}, {}, {}), ({}, {}, {"bert_attn_impl": "fast"}),
             ({}, {}, {"bert_attn_impl": "default"}),
             ({"attn_impl": "default"}, {}, {"bert_attn_impl": "fast"}),
             ({"attn_impl": "fast"}, {}, {"bert_attn_impl": "default"})]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(ATTN_ROWS))
def test_bert_attn_impl_matches_jax(knobs, arg, env, prof, dev):
    knobs(prof, env, dev)
    j = jtr.bert_large_config(num_layers=2, **arg).attn_impl
    p = ptr.bert_large_config(num_layers=2, **arg).attn_impl
    assert p == j
    if not dev and not arg:
        assert p == "default"


# -- the ZeRO optimizers' impl=None ------------------------------------------

ZERO_ROWS = [(None, {}, {}), (None, {}, {"zero_impl": "fused"}),
             (None, {}, {"zero_impl": "xla"}),
             ("xla", {}, {"zero_impl": "fused"}),
             ("fused", {}, {"zero_impl": "xla"}), ("cuda", {}, {})]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(ZERO_ROWS))
@pytest.mark.parametrize("cls", ["DistributedFusedAdam",
                                 "DistributedFusedLAMB"])
def test_zero_impl_matches_jax(knobs, cls, arg, env, prof, dev):
    knobs(prof, env, dev)
    j = _decide(lambda: getattr(jdf, cls)(lr=1e-3, impl=arg).impl)
    p = _decide(lambda: getattr(pdf, cls)(lr=1e-3, impl=arg).impl)
    assert p == j
    if not dev and arg is None:
        assert p == "xla"


# -- collectives.resolve -----------------------------------------------------

COLL_ROWS = [
    ((None, "ddp_collective_scheme"), {}, {}),
    ((None, "ddp_collective_scheme"), {}, {"ddp_collective_scheme": "bf16"}),
    ((None, "ddp_collective_scheme"), {},
     {"ddp_collective_scheme": "int8_blockscale",
      "collective_min_compress_bytes": 65536}),
    ((None, "ddp_collective_scheme"), {},
     {"collective_min_compress_bytes": 65536}),
    ((None, None), {}, {"ddp_collective_scheme": "bf16"}),
    ((None, "ddp_collective_scheme"),
     {"APEX_TPU_COLLECTIVES": "int8_blockscale:min_bytes=4"},
     {"ddp_collective_scheme": "bf16"}),
    ((None, "ddp_collective_scheme"), {"APEX_TPU_COLLECTIVES": "off"},
     {"ddp_collective_scheme": "bf16"}),
    ((None, "ddp_collective_scheme"), {"APEX_TPU_COLLECTIVES": "nope"}, {}),
    (("fp32", "ddp_collective_scheme"), {"APEX_TPU_COLLECTIVES": "bf16"},
     {"ddp_collective_scheme": "adasum"}),
    (("adasum", None), {}, {"ddp_collective_scheme": "bf16",
                            "collective_min_compress_bytes": 8}),
]


def _spec(s):
    if isinstance(s, str) or s is None:
        return s
    return (s.scheme, s.block, s.min_bytes)


@pytest.mark.parametrize("arg,env,prof,dev", _cases(COLL_ROWS))
def test_collective_scheme_matches_jax(knobs, arg, env, prof, dev):
    knobs(prof, env, dev)
    scheme, key = arg
    j = _decide(lambda: _spec(jcoll.resolve(scheme, tuning_key=key)))
    p = _decide(lambda: _spec(pcoll.resolve(scheme, tuning_key=key)))
    assert p == j or (p == "CollectiveError" and j == "CollectiveError")
    if not dev and scheme is None and not env:
        assert p is None
    # min_bytes given by the caller beats the profile's threshold
    if not env and dev and prof.get("ddp_collective_scheme") and key:
        assert _spec(pcoll.resolve(None, min_bytes=7))[2] == \
            _spec(jcoll.resolve(None, min_bytes=7))[2] == 7


def test_the_live_override_beats_the_profile(knobs):
    knobs({"ddp_collective_scheme": "bf16"}, {}, True)
    jcoll.set_live_spec("adasum")
    pcoll.set_live_spec("adasum")
    try:
        assert _spec(pcoll.resolve()) == _spec(jcoll.resolve())
        assert _spec(pcoll.resolve())[0] == "adasum"
    finally:
        jcoll.set_live_spec(None)
        pcoll.set_live_spec(None)


# -- overlap and weight-update modes -----------------------------------------

def _mode_rows(env_knob, key, on):
    return [(None, {}, {}), (None, {}, {key: on}), (None, {}, {key: "off"}),
            (None, {env_knob: "off"}, {key: on}),
            (None, {env_knob: f" {on.upper()} "}, {key: "off"}),
            (None, {env_knob: "  "}, {key: on}),
            (None, {env_knob: "bogus"}, {}),
            ("off", {env_knob: on}, {key: on}),
            (on, {}, {}), ("bogus", {}, {})]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(
    _mode_rows("APEX_TPU_OVERLAP", "ddp_overlap", "bucketed")))
def test_overlap_mode_matches_jax(knobs, arg, env, prof, dev):
    knobs(prof, env, dev)
    assert jov.TUNING_KEY == pov.TUNING_KEY == "ddp_overlap"
    j = _decide(lambda: jov.resolve_mode(arg))
    p = _decide(lambda: pov.resolve_mode(arg))
    assert p == j
    if not dev and arg is None and not env:
        assert p == "off"


@pytest.mark.parametrize("arg,env,prof,dev", _cases(
    _mode_rows("APEX_TPU_UPDATE_SHARDING", "ddp_update_sharding", "zero1")))
def test_update_sharding_mode_matches_jax(knobs, arg, env, prof, dev):
    knobs(prof, env, dev)
    assert jwu.TUNING_KEY == pwu.TUNING_KEY == "ddp_update_sharding"
    j = _decide(lambda: jwu.resolve_mode(arg))
    p = _decide(lambda: pwu.resolve_mode(arg))
    assert p == j
    if not dev and arg is None and not env:
        assert p == "off"


AG_ROWS = [
    (None, {}, {}), (None, {}, {"ddp_update_allgather_scheme": "bf16"}),
    (None, {}, {"ddp_update_allgather_scheme": "fp32"}),
    (None, {}, {"ddp_update_allgather_scheme": "int8_blockscale"}),
    (None, {"APEX_TPU_COLLECTIVES": "int8_blockscale"}, {}),
    (None, {"APEX_TPU_COLLECTIVES": "bf16"},
     {"ddp_update_allgather_scheme": "int8_blockscale",
      "ddp_collective_scheme": "bf16"}),
    ("bf16", {}, {"ddp_update_allgather_scheme": "int8_blockscale"}),
    ("nope", {}, {}),
]


@pytest.mark.parametrize("arg,env,prof,dev", _cases(AG_ROWS))
def test_update_allgather_scheme_matches_jax(knobs, arg, env, prof, dev):
    """The zero1 param all-gather: explicit > ``AG_TUNING_KEY`` > fp32,
    never the ambient ``APEX_TPU_COLLECTIVES``."""
    knobs(prof, env, dev)
    assert jwu.AG_TUNING_KEY == pwu.AG_TUNING_KEY
    j = _decide(lambda: _spec(jwu.ShardedUpdate(
        JFusedAdam(impl="fused"), allgather_scheme=arg)._resolve_ag()))
    p = _decide(lambda: _spec(pwu.ShardedUpdate(
        PFusedAdam(impl="fused"), allgather_scheme=arg)._resolve_ag()))
    assert p == j
    if not dev and arg is None:
        assert p is None


def test_a_profile_is_never_read_before_cuda_is_up(knobs, monkeypatch):
    """Off the device every reader gives its built-in, and none of them
    brings CUDA up (``get_on_gpu`` asks ``_cuda_initialized`` only)."""
    knobs({"flash_bwd_impl": "xla", "flash_bwd_fuse": False,
           "xent_auto_impl": "xla", "layer_norm_use_pallas": False,
           "mlp_use_pallas": False, "bert_attn_impl": "fast",
           "zero_impl": "fused", "ddp_collective_scheme": "bf16",
           "ddp_overlap": "bucketed", "ddp_update_sharding": "zero1",
           "ddp_update_allgather_scheme": "bf16"}, {}, False)
    reads = []
    real = tuning._load
    monkeypatch.setattr(tuning, "_load", lambda: reads.append(1) or real())
    assert pflash._resolve_backward("auto") == "pallas"
    assert pflash._resolve_fuse(None, 128, 512, 512, 64) is True
    assert px._resolve_impl("auto", "cuda") == "pallas"
    assert pfln._resolve_use_pallas(None) is True
    assert pmlp.MLP([4, 4]).use_pallas is True
    assert ptr.bert_large_config().attn_impl == "default"
    assert pdf.DistributedFusedAdam(lr=1e-3).impl == "xla"
    assert pcoll.resolve() is None
    assert pov.resolve_mode() == "off" and pwu.resolve_mode() == "off"
    assert pwu.ShardedUpdate(PFusedAdam(impl="fused"))._resolve_ag() is None
    assert reads == []
    assert not torch.cuda.is_initialized()


# -- the flash block keys and pins: no counterpart ---------------------------

BLOCK_PROFILE = {"flash_block_q": 256, "flash_block_k": 512,
                 "flash_bwd_block_q": 64, "flash_bwd_block_k": 256,
                 "flash_bwd_dq_block_q": 32, "flash_bwd_dq_block_k": 128,
                 "flash_bwd_dkv_block_q": 16, "flash_bwd_dkv_block_k": 256}
BLOCK_ENV = {"APEX_TPU_FLASH_BLOCK_Q": "64", "APEX_TPU_FLASH_BLOCK_K": "128",
             "APEX_TPU_FLASH_BWD_BLOCK_Q": "8",
             "APEX_TPU_FLASH_BWD_BLOCK_K": "128",
             "APEX_TPU_FLASH_BWD_DQ_BLOCK_Q": "16",
             "APEX_TPU_FLASH_BWD_DQ_BLOCK_K": "256",
             "APEX_TPU_FLASH_BWD_DKV_BLOCK_Q": "32",
             "APEX_TPU_FLASH_BWD_DKV_BLOCK_K": "512",
             "APEX_TPU_FLASH_VMEM_MB": "0.01"}


def _flash_run(seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(4, 40, 32, generator=g).requires_grad_(True)
               for _ in range(3))
    bias = torch.zeros(1, 1, 40)
    out = pflash.flash_attention(q, k, v, bias, heads=2)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.randn(4, 40, 32, generator=g))
    return [out.detach()] + list(grads)


@pytest.mark.parametrize("which", ["profile", "env", "both"])
def test_flash_block_keys_and_pins_change_nothing(knobs, monkeypatch,
                                                  which):
    """The JAX block keys and pins move the JAX blocks (its own tests);
    in the port they change no decision, no bit of the outputs and
    gradients, no launch count, and no tuning key is read for them."""
    knobs({}, {}, True)
    base = _flash_run()
    base_decisions = [pflash._resolve_fuse(None, *s) for s in FUSE_SHAPES]
    base_launches = dict(build.LAUNCHES)
    knobs(BLOCK_PROFILE if which != "env" else {},
          BLOCK_ENV if which != "profile" else {}, True)
    assert jflash._clamp_blocks(None, None, D=64, esz=2, bias_per_q=False) \
        != (jflash.DEFAULT_BLOCK_Q, jflash.DEFAULT_BLOCK_K)
    keys = []
    real = tuning.get_on_gpu
    monkeypatch.setattr(tuning, "get_on_gpu",
                        lambda k, d=None: keys.append(k) or real(k, d))
    again = _flash_run()
    for a, b in zip(base, again):
        assert torch.equal(a, b)
    assert [pflash._resolve_fuse(None, *s) for s in FUSE_SHAPES] \
        == base_decisions
    assert pflash._resolve_backward("auto") == "pallas"
    assert dict(build.LAUNCHES) == base_launches
    assert not any("block" in k for k in keys)
    assert set(keys) <= {"flash_bwd_impl", "flash_bwd_fuse"}
