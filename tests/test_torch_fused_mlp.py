"""The fused MLP of the PyTorch port against the JAX package.

``fused_dense_act`` (its plain version on the CPU) against the JAX
``fused_dense_act`` (the Pallas kernel in interpret mode, with small blocks
so the ragged shapes 10 x 24 @ 24 x 12 and 9 x 16 @ 16 x 8 pad edge
tiles), over relu / sigmoid / none, with and without a bias, in fp32, bf16
and fp16.  Tolerances, per element, ``|port - jax| <= tol * max(1,
|jax|)``: fp32 1e-5 (the JAX tests' own); bf16 2e-2 and fp16 2e-3, since
both sides round one fp32 value whose sums ran in other orders and may
land on neighbouring 16-bit numbers (2^-8 and 2^-11 apart relative).
``dense_act``'s gradients against the JAX ``custom_vjp``'s, fp32, within
1e-5 (the same formula; products in other orders).  ``MLP.apply`` (one
route: ``dense_act`` a layer) against both JAX routes, ``use_pallas`` True
and False, through ``mlp_params_from_jax``: fp32 within 1e-5, fp16 within
2e-3.  The CUDA kernels are compared with the plain version on the card
by ``tests/test_torch_cuda_kernels.py``; here ``_route``, which picks one
of them before a launch, is checked on CPU tensors (it reads shapes,
dtypes and addresses only), and a CPU tensor is shown to reach no route.
Under amp's casts (O1's fp16, O4's bf16), ``mlp_function`` and
``MLP.apply`` on fp32 x, w and b give the JAX package's dtype and values
(the 16-bit limits above): both cast x alone.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.amp import amp as jamp_mod
from apex_tpu.mlp import MLP as JaxMLP
from apex_tpu.mlp import mlp_function as jax_mlp_function
from apex_tpu.ops import dense_act as jax_dense_act
from apex_tpu.ops import fused_dense_act as jax_fused_dense_act

from apex_tpu_torch.amp import amp as amp_mod
from apex_tpu_torch.mlp import MLP, mlp_function, mlp_params_from_jax
from apex_tpu_torch.ops import fused_mlp
from apex_tpu_torch.ops.fused_mlp import dense_act, fused_dense_act

from _torch_port import amp_uninit  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}


def _close(got: torch.Tensor, ref, tol: float):
    ref = np.asarray(ref).astype(np.float32)
    err = np.abs(got.float().numpy() - ref)
    assert (err <= tol * np.maximum(1.0, np.abs(ref))).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("m,k,n", [(10, 24, 12), (9, 16, 8)])
def test_fused_dense_act_matches_pallas(m, k, n, activation, bias, dtype):
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.3
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jdt = jnp.dtype(dtype)
    ref = jax_fused_dense_act(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt),
        None if b is None else jnp.asarray(b, jdt), activation,
        block_m=8, block_n=8, block_k=8)
    tdt = getattr(torch, dtype)
    got = fused_dense_act(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(w).to(tdt),
                          None if b is None else torch.from_numpy(b).to(tdt),
                          activation)
    assert got.dtype == tdt and got.shape == (m, n)
    _close(got, ref.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("bias", [True, False])
def test_dense_act_grads_match_custom_vjp(activation, bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if bias else None
    t = rng.standard_normal((6, 8)).astype(np.float32)

    def jloss(x, w, b):
        return jnp.sum((jax_dense_act(x, w, b, activation) - t) ** 2)

    argnums = (0, 1, 2) if bias else (0, 1)
    jg = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    xs = [torch.from_numpy(a).requires_grad_(True)
          for a in ((x, w, b) if bias else (x, w))]
    out = dense_act(xs[0], xs[1], xs[2] if bias else None, activation)
    ((out - torch.from_numpy(t)) ** 2).sum().backward()
    for a, r in zip(xs, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_dense_act_grads_keep_their_dtypes(dtype):
    """Gradients come back in each input's dtype, from fp32 products, as the
    JAX backward casts them."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(6)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(tdt).requires_grad_(True) for s in ((5, 7), (7, 3), (3,)))
    dense_act(x, w, b, "sigmoid").float().sum().backward()
    assert (x.grad.dtype, w.grad.dtype, b.grad.dtype) == (tdt, tdt, tdt)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
def test_mlp_matches_both_jax_routes(activation, dtype):
    sizes = [16, 32, 24, 8]
    jparams = JaxMLP(sizes, activation=activation).init(jax.random.PRNGKey(3))
    jdt = jnp.dtype(dtype)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jdt), jparams)
    x = np.random.default_rng(7).standard_normal((12, 16)).astype(np.float32)
    params = mlp_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    got = MLP(sizes, activation=activation, use_pallas=True)(
        params, torch.from_numpy(x).to(getattr(torch, dtype)))
    for use_pallas in (True, False):
        ref = JaxMLP(sizes, activation=activation,
                     use_pallas=use_pallas).apply(jparams,
                                                  jnp.asarray(x, jdt))
        assert got.dtype == getattr(torch, dtype)
        _close(got, ref.astype(jnp.float32), TOL[dtype])
    assert torch.equal(mlp_function(torch.from_numpy(x).to(got.dtype),
                                    params["weights"], params["biases"],
                                    activation), got)


def test_mlp_init_shapes_and_statistics():
    """Xavier-normal (in, out) weights, N(0, 1/fan_out) biases, from the
    generator, fp32; the same seed gives the same weights."""
    mlp = MLP([256, 512, 128])
    p = mlp.init(torch.Generator().manual_seed(0), device="cpu")
    q = mlp.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(w.shape) for w in p["weights"]] == [(256, 512), (512, 128)]
    assert [tuple(b.shape) for b in p["biases"]] == [(512,), (128,)]
    for a, b in zip(p["weights"] + p["biases"], q["weights"] + q["biases"]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    np.testing.assert_allclose(float(p["weights"][0].std()),
                               (2.0 / 768) ** 0.5, rtol=0.05)
    np.testing.assert_allclose(float(p["biases"][0].std()),
                               (1.0 / 512) ** 0.5, rtol=0.2)
    nobias = MLP([4, 4], bias=False).init(torch.Generator(), device="cpu")
    assert nobias["biases"] == [None]


def test_bad_activation_and_inputs_raise():
    with pytest.raises(ValueError):
        MLP([4, 4], activation="gelu")
    x, w = torch.zeros(3, 4), torch.zeros(4, 5)
    with pytest.raises(ValueError):
        fused_dense_act(x, w, None, "tanh")
    with pytest.raises(ValueError):
        fused_mlp._check_cuda_inputs(x, torch.zeros(5, 4), None)
    with pytest.raises(TypeError):
        fused_mlp._check_cuda_inputs(x, w.half(), None)
    with pytest.raises(TypeError):
        fused_mlp._check_cuda_inputs(x.double(), w.double(), None)
    with pytest.raises(ValueError):
        fused_mlp._check_cuda_inputs(x, w, torch.zeros(4))
    with pytest.raises(ValueError):
        fused_mlp._check_cuda_inputs(x, torch.zeros(5, 4).T, None)
    assert fused_mlp._check_cuda_inputs(x.half(), w.half(),
                                        torch.zeros(5).half()) == 2


def _operand(shape, dtype, offset=0):
    """A contiguous (rows, cols) tensor ``offset`` elements into a fresh
    buffer (1: two or four bytes past a 16-byte aligned base)."""
    rows, cols = shape
    buf = torch.empty(rows * cols + offset, dtype=getattr(torch, dtype))
    return buf[offset:].view(rows, cols)


MLP_LAYERS = [(8192, 1024, 4096), (8192, 4096, 4096), (8192, 4096, 1024)]


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("m,k,n,x_off,w_off,want", [
    *[(m, k, n, 0, 0, "sm90") for m, k, n in MLP_LAYERS],
    (1, 1024, 4096, 0, 0, "sm90"),        # M = 1
    (8191, 1000, 136, 0, 0, "sm90"),      # tails of the tiles, K and N % 8
    (64, 1001, 64, 0, 0, "mma"),          # K not a multiple of 8
    (64, 64, 100, 0, 0, "mma"),           # N not a multiple of 8
    (64, 64, 64, 1, 0, "mma"),            # x one element past aligned
    (64, 64, 64, 0, 1, "mma"),            # w one element past aligned
])
def test_route_names_the_kernel(m, k, n, x_off, w_off, want, dtype):
    x = _operand((m, k), dtype, x_off)
    w = _operand((k, n), dtype, w_off)
    b = torch.empty(n, dtype=x.dtype)
    assert x.is_contiguous() and w.is_contiguous()
    assert fused_mlp._check_cuda_inputs(x, w, b) in (1, 2)
    assert fused_mlp._route(x, w) == want
    assert fused_mlp.ROUTES[want].startswith("dense_act_")


@pytest.mark.parametrize("m,k,n,x_off", [(8192, 4096, 4096, 0),
                                         (10, 24, 12, 0), (64, 64, 64, 1)])
def test_route_of_fp32_is_the_simt_kernel(m, k, n, x_off):
    x = _operand((m, k), "float32", x_off)
    w = _operand((k, n), "float32")
    assert fused_mlp._route(x, w) == "f32"
    assert fused_mlp.ROUTES["f32"] == "dense_act_f32_kernel"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cpu_tensor_reaches_no_route(dtype, monkeypatch):
    """A CPU tensor takes the plain version: neither the route function
    nor the kernel library is asked, and no launch is counted."""
    from apex_tpu_torch.utils import build

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA dispatch")
    monkeypatch.setattr(fused_mlp, "_route", refuse)
    monkeypatch.setattr(build, "library", refuse)
    rng = np.random.default_rng(5)
    tdt = getattr(torch, dtype)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(tdt) for s in ((9, 16), (16, 8), (8,)))
    before = dict(build.LAUNCHES)
    out = fused_dense_act(x, w, b, "relu")
    assert torch.equal(out, fused_mlp.fused_dense_act_reference(x, w, b,
                                                                "relu"))
    assert dict(build.LAUNCHES) == before


@pytest.mark.parametrize("level,low", [("O1", "float16"), ("O4", "bfloat16")])
def test_mlp_function_under_amp_casts_matches_jax(level, low):
    """fp32 x, w and b under amp's casts: the JAX package's ``mlp_function``
    and both ``MLP`` routes are half functions, so x is cast to the
    low-precision type (the weights are not) and the output comes in it;
    the port's ``mlp_function`` and ``MLP.apply`` give the same dtype and
    values."""
    sizes = [16, 32, 8]
    jparams = JaxMLP(sizes).init(jax.random.PRNGKey(5))
    params = mlp_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    x = np.random.default_rng(11).standard_normal((6, 16)).astype(np.float32)
    with jamp_mod.autocast(jnp.dtype(low)):
        refs = [jax_mlp_function(jnp.asarray(x), jparams["weights"],
                                 jparams["biases"], "relu")]
        refs += [JaxMLP(sizes, use_pallas=p).apply(jparams, jnp.asarray(x))
                 for p in (True, False)]
    with amp_mod.autocast(getattr(torch, low)):
        gots = [mlp_function(torch.from_numpy(x), params["weights"],
                             params["biases"], "relu"),
                MLP(sizes, use_pallas=True)(params, torch.from_numpy(x))]
    for ref in refs:
        assert ref.dtype == jnp.dtype(low), level
        for got in gots:
            assert got.dtype == getattr(torch, low), level
            _close(got, ref.astype(jnp.float32), TOL[low])
    # without the casts the function is mlp_pallas: fp32 in, fp32 out
    assert mlp_function(torch.from_numpy(x), params["weights"],
                        params["biases"], "relu").dtype == torch.float32
