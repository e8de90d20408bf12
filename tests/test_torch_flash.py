"""Flash attention of the PyTorch port against the JAX package.

The same numpy inputs go to ``apex_tpu``'s ``_flash_fwd`` / ``_flash_bwd``
(the Pallas kernels, in interpret mode on the CPU; the backward on its
fused route) and to the port's, which on a CPU tensor take their plain
versions; out and lse, then dq, dk and dv are compared, and the port's
autograd gradients are held to ``jax.grad`` through ``flash_attention``.
fp32 tolerances: forward 2e-5 (blockwise online softmax against the plain
full-row softmax), backward 5e-5 (five products, summed in other orders).
The split route's plain versions (dq alone, dk/dv alone) go against the
JAX package's ``_flash_bwd_dq`` / ``_flash_bwd_dkv`` kernels (interpret
mode) at the same 5e-5, and the port's two routes give the same bits on
the CPU.
The dropout hash is compared bit for bit.  Rows whose every visible key
carries a large finite mask (-1e9) go through the port's kernel route
(``backward="pallas"``, its plain recompute here) and are held to the JAX
package's ``backward="xla"`` at 1e-4 on the peak rule: the backward
rebuilds P from the row max and log l kept apart, where the JAX kernels'
rebuild from lse alone is wrong.  The CUDA kernels themselves are
compared with the plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.multihead_attn import flash as jflash

from apex_tpu_torch.contrib.multihead_attn import flash as pflash

TOL = 2e-5

# (name, B, heads, Sq, Sk, D, bias kind, causal, dropout)
CASES = [
    ("causal", 2, 2, 24, 24, 16, "zeros", True, 0.0),
    ("bidirectional", 2, 2, 24, 24, 16, "zeros", False, 0.0),
    ("key_padding", 2, 3, 20, 20, 8, "key_pad", False, 0.0),
    ("key_padding_causal", 2, 3, 20, 20, 8, "key_pad", True, 0.0),
    ("full_bias", 2, 2, 16, 16, 16, "full", False, 0.0),
    ("ragged", 1, 2, 40, 72, 32, "key_pad", False, 0.0),
    ("ragged_causal", 1, 2, 72, 40, 32, "zeros", True, 0.0),
    ("dead_row", 2, 2, 16, 24, 16, "dead", False, 0.0),
    ("dropout", 2, 2, 24, 24, 16, "zeros", False, 0.1),
    ("dropout_causal_key_pad", 2, 2, 40, 40, 16, "key_pad", True, 0.1),
]


def _inputs(B, heads, sq, sk, d, kind, seed):
    rng = np.random.default_rng(seed)
    bh = B * heads
    q = (rng.standard_normal((bh, sq, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    if kind == "zeros":
        bias = np.zeros((1, 1, sk), np.float32)
    elif kind == "key_pad":       # last keys of each batch row padded out
        bias = np.zeros((B, 1, sk), np.float32)
        for b in range(B):
            bias[b, 0, sk - 3 - b:] = -1e9
    elif kind == "full":
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
    else:                         # "dead": rows that see only -1e30 keys
        bias = rng.standard_normal((B, sq, sk)).astype(np.float32)
        bias[0, 3, :] = pflash.NEG_INF
        bias[1, 0, :] = pflash.NEG_INF
    return q, k, v, bias


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_fwd_matches_pallas(case):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _inputs(B, heads, sq, sk, d, kind, seed=sq * sk + d)
    seed = 1234
    j_out, j_lse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(bias),
                                     causal, rate, seed, heads)
    p_out, p_lse = pflash._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(bias), causal, rate,
                                     seed, heads)
    assert p_out.shape == q.shape and p_lse.shape == (B * heads, sq, 1)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse),
                               atol=TOL, rtol=TOL)
    if kind == "dead":
        assert np.all(p_out.numpy()[0, 3] == 0.0)
        assert p_lse.numpy()[0, 3, 0] == -pflash.NEG_INF


def test_flash_attention_returns_out():
    q, k, v, bias = _inputs(1, 2, 16, 16, 8, "zeros", seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out = pflash.flash_attention(*args, seed=0, causal=True, heads=2)
    ref = jflash.flash_attention(*[jnp.asarray(a) for a in (q, k, v, bias)],
                                 seed=0, causal=True, heads=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
@pytest.mark.parametrize("bh", [0, 5, 31])
@pytest.mark.parametrize("row0,col0", [(0, 0), (2 ** 31 - 4, 17),
                                       (123, 2 ** 31 - 6),
                                       (2 ** 31 - 2, 2 ** 31 - 3),
                                       (125, 509), (509, 125)])
def test_dropout_keep_bit_exact(seed, bh, row0, col0):
    shape = (8, 8)
    for rate in (0.1, 0.5, 0.9):
        ref = jflash._dropout_keep(jnp.int32(seed), jnp.int32(bh), row0, col0,
                                   shape, rate)
        got = pflash._dropout_keep(seed, bh, row0, col0, shape, rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dropout_keep_rate_is_honest():
    keep = pflash._dropout_keep(11, torch.arange(4)[:, None, None], 0, 0,
                                (64, 64), 0.25)
    assert keep.shape == (4, 64, 64)
    assert abs(keep.mean().item() - 0.75) < 0.02


@pytest.mark.parametrize("bad", ["bias_batch", "heads", "bias_rows", "kv"])
def test_layout_errors(bad):
    q = torch.zeros(4, 8, 16)
    k = v = torch.zeros(4, 8, 16)
    bias, heads = torch.zeros(1, 1, 8), 2
    if bad == "bias_batch":
        bias = torch.zeros(3, 1, 8)
    elif bad == "heads":
        heads = 3
    elif bad == "bias_rows":
        bias = torch.zeros(1, 5, 8)
    else:
        v = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError):
        pflash._flash_fwd(q, k, v, bias, False, 0.0, 0, heads)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "bias_dtype", "rate"])
def test_kernel_input_checks(bad):
    """The checks the CUDA wrapper applies before a launch."""
    q = k = v = torch.zeros(2, 8, 64)
    bias, rate = torch.zeros(1, 1, 8), 0.0
    if bad == "head_dim":
        q = k = v = torch.zeros(2, 8, 48)
    elif bad == "dtype":
        # fp32, bf16 and fp16 are taken; float64 has no kernel
        q = k = v = torch.zeros(2, 8, 64, dtype=torch.float64)
    elif bad == "bias_dtype":
        bias = bias.double()
    else:
        rate = 1.0
    with pytest.raises((ValueError, TypeError)):
        pflash._check_cuda_inputs(q, k, v, bias, rate)


def test_kernel_refuses_grad():
    """The forward kernel no longer refuses inputs that require a gradient:
    ``flash_attention`` pairs it with the backward kernel."""
    q = torch.zeros(2, 8, 64, requires_grad=True)
    k = v = torch.zeros(2, 8, 64)
    pflash._check_cuda_inputs(q, k, v, torch.zeros(1, 1, 8), 0.0)


BWD_TOL = 5e-5


def _dout(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_matches_pallas(case):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _inputs(B, heads, sq, sk, d, kind, seed=sq + sk + d)
    do = _dout(q.shape, seed=sq)
    seed = 77
    jq, jk, jv, jb, jdo = (jnp.asarray(a) for a in (q, k, v, bias, do))
    j_out, j_lse = jflash._flash_fwd(jq, jk, jv, jb, causal, rate, seed,
                                     heads)
    ref = jflash._flash_bwd(jq, jk, jv, jb, causal, rate, seed, heads,
                            j_out, j_lse, jdo, fuse=True)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, bias, j_out, j_lse,
                                                 do)]
    got = pflash._flash_bwd(t[0], t[1], t[2], t[3], causal, rate, seed,
                            heads, t[4], t[5], t[6])
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BWD_TOL,
                                   rtol=BWD_TOL, err_msg=name)
    if kind == "dead":
        assert np.all(got[0].numpy()[0, 3] == 0.0)


@pytest.mark.parametrize("backward", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[5], CASES[7],
                                  CASES[9]],
                         ids=[CASES[i][0] for i in (0, 3, 5, 7, 9)])
def test_flash_attention_grads_match_jax(case, backward):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _inputs(B, heads, sq, sk, d, kind, seed=3 * sq + d)
    do = _dout(q.shape, seed=sk)
    seed = 5

    def jloss(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, jnp.asarray(bias), seed,
                                     causal, rate, heads, backward)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = pflash.flash_attention(*qkv, torch.from_numpy(bias), seed=seed,
                                 causal=causal, dropout_rate=rate,
                                 heads=heads, backward=backward)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BWD_TOL,
                                   rtol=BWD_TOL, err_msg=name)


def test_backward_selection():
    assert pflash._resolve_backward("xla") == "xla"
    assert pflash._resolve_backward("pallas") == "pallas"
    assert pflash._resolve_backward("auto") == "pallas"
    try:
        pflash.set_default_backward("xla")
        assert pflash._resolve_backward("auto") == "xla"
        assert pflash._resolve_backward("pallas") == "pallas"
    finally:
        pflash.set_default_backward("auto")
    with pytest.raises(ValueError):
        pflash._resolve_backward("triton")
    with pytest.raises(ValueError):
        pflash.set_default_backward("cuda")
    with pytest.raises(ValueError):
        pflash.flash_attention(*[torch.zeros(1, 4, 8)] * 3,
                               torch.zeros(1, 1, 4), backward="fast")


def _bwd_inputs(case, seed):
    _, B, heads, sq, sk, d, kind, causal, rate = case
    q, k, v, bias = _inputs(B, heads, sq, sk, d, kind, seed=seed)
    do = _dout(q.shape, seed=sq + 1)
    jq, jk, jv, jb, jdo = (jnp.asarray(a) for a in (q, k, v, bias, do))
    j_out, j_lse = jflash._flash_fwd(jq, jk, jv, jb, causal, rate, 31, heads)
    j_delta = jnp.sum(jdo * j_out, axis=-1, keepdims=True)
    jax_args = (jq, jk, jv, jb, causal, rate, 31, heads, j_lse, j_delta, jdo)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, bias, j_lse,
                                                 j_delta, do, j_out)]
    port_args = (t[0], t[1], t[2], t[3], causal, rate, 31, heads, t[4], t[5],
                 t[6])
    return jax_args, port_args, t[7]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_split_matches_pallas(case):
    jax_args, port_args, _ = _bwd_inputs(case, seed=case[3] * 7 + case[5])
    ref_dq = jflash._flash_bwd_dq(*jax_args)
    ref_dk, ref_dv = jflash._flash_bwd_dkv(*jax_args)
    dq = pflash._flash_bwd_dq(*port_args)
    dk, dv = pflash._flash_bwd_dkv(*port_args)
    for name, a, r in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                       ("dv", dv, ref_dv)):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BWD_TOL,
                                   rtol=BWD_TOL, err_msg=name)
    if case[6] == "dead":
        assert np.all(dq.numpy()[0, 3] == 0.0)


@pytest.mark.parametrize("case", [CASES[0], CASES[5], CASES[7], CASES[9]],
                         ids=[CASES[i][0] for i in (0, 5, 7, 9)])
def test_split_route_equals_fused_route_on_cpu(case):
    _, port_args, out = _bwd_inputs(case, seed=case[4] + 3)
    q, k, v, bias, causal, rate, seed, heads, lse, _, do = port_args
    fused = pflash._flash_bwd(q, k, v, bias, causal, rate, seed, heads, out,
                              lse, do, fuse=True)
    split = pflash._flash_bwd(q, k, v, bias, causal, rate, seed, heads, out,
                              lse, do, fuse=False)
    for name, a, b in zip(("dq", "dk", "dv"), fused, split):
        assert torch.equal(a, b), name


def test_fuse_rule_is_the_byte_cap():
    # the port's dq-partial tile is the JAX package's default 128-key block
    assert pflash.BWD_K_TILE == 128
    # the training shape: 128 x 4 x 512 x 64 x 4 B = 67 MB of dq partials
    assert pflash._resolve_fuse(None, 128, 512, 512, 64)
    # past 1024 MB the split route runs: the long-sequence training shape
    assert not pflash._resolve_fuse(None, 64, 4096, 4096, 64)
    # exactly 1024 MB fuses, in both packages; one key tile more splits
    assert pflash._resolve_fuse(None, 128, 2048, 2048, 64)
    assert not pflash._resolve_fuse(None, 128, 2048, 2049, 64)
    assert pflash._resolve_fuse(False, 1, 8, 8, 64) is False
    assert pflash._resolve_fuse(True, 128, 4096, 4096, 64) is True


# (BH, Sq, Sk, D): the training and long-sequence shapes, the 1024 MB cap
# exactly (BH 128 x 2048^2 x 64, BH 16 x 4096^2 x 128), just over it (one
# more key tile, one more head), ragged and tiny shapes
FUSE_SHAPES = [
    (128, 512, 512, 64), (64, 4096, 4096, 64), (128, 2048, 2048, 64),
    (128, 2048, 2049, 64), (129, 2048, 2048, 64), (16, 4096, 4096, 128),
    (16, 4096, 4097, 128), (8, 200, 333, 64), (1, 1, 1, 32),
    (256, 1024, 4096, 32), (64, 8192, 1000, 64),
]


@pytest.mark.parametrize("shape", FUSE_SHAPES,
                         ids=["x".join(map(str, s)) for s in FUSE_SHAPES])
def test_fuse_rule_matches_jax_package(shape, monkeypatch):
    """The port's route is the JAX package's at its default 128-key block,
    with the JAX package's environment overrides cleared."""
    for name in ("APEX_TPU_FLASH_BWD_FUSE", "APEX_TPU_FLASH_BWD_FUSE_MB"):
        monkeypatch.delenv(name, raising=False)
    assert pflash._resolve_fuse(None, *shape) == \
        jflash._resolve_fuse(None, *shape, 128)


def test_bias_gets_no_gradient():
    q, k, v, bias = _inputs(1, 2, 8, 8, 8, "full", seed=1)
    b = torch.from_numpy(bias).requires_grad_(True)
    qt = torch.from_numpy(q).requires_grad_(True)
    out = pflash.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                 b, heads=2)
    out.sum().backward()
    assert b.grad is None and qt.grad is not None


# head dims between the kernel instances: (D, causal, dropout)
PAD_CASES = [(d, causal, rate) for d in (48, 80, 96)
             for causal in (False, True) for rate in (0.0, 0.1)]


@pytest.mark.parametrize("d,causal,rate", PAD_CASES,
                         ids=[f"d{c[0]}-{'causal' if c[1] else 'full'}-"
                              f"p{c[2]}" for c in PAD_CASES])
def test_head_dim_padding_is_exact(d, causal, rate):
    """What a CUDA call at D not in HEAD_DIMS does around the kernels: pad
    q, k, v and dO with zero columns to the next instance, slice out, dq,
    dk and dv back.  On the CPU, the plain forward, the plain backward and
    autograd of the plain forward on the padded inputs, sliced, equal their
    unpadded results within 1e-6."""
    dp = pflash._kernel_head_dim(d)
    assert dp == (64 if d <= 64 else 128)
    q, k, v, bias = _inputs(2, 2, 24, 20, d, "key_pad", seed=d + 7)
    do = _dout(q.shape, seed=d)
    t = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    pq, pk, pv, pdo = pflash._pad_head_dim((t[0], t[1], t[2], t[4]), dp)
    for a, p in zip((t[0], t[1], t[2], t[4]), (pq, pk, pv, pdo)):
        assert p.shape[-1] == dp and p.is_contiguous()
        assert torch.equal(p[..., :d], a) and bool((p[..., d:] == 0).all())
    args = (t[3], causal, rate, 31, 2)
    out, lse = pflash._reference(t[0], t[1], t[2], *args)
    p_out, p_lse = pflash._reference(pq, pk, pv, *args)
    assert bool((p_out[..., d:] == 0).all())
    np.testing.assert_allclose(p_out[..., :d].numpy(), out.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(p_lse.numpy(), lse.numpy(), atol=1e-6,
                               rtol=1e-6)
    delta = (t[4] * out).sum(-1, keepdim=True)
    ref = pflash._flash_bwd_reference(t[0], t[1], t[2], *args, lse, delta,
                                      t[4])
    got = pflash._flash_bwd_reference(pq, pk, pv, *args, lse, delta, pdo)
    auto = pflash._xla_bwd(t[0], t[1], t[2], *args, t[4])
    p_auto = pflash._xla_bwd(pq, pk, pv, *args, pdo)
    for name, a, r in zip(("dq", "dk", "dv", "auto dq", "auto dk",
                           "auto dv"), got + p_auto, ref + auto):
        np.testing.assert_allclose(a[..., :d].numpy(), r.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
        assert bool((a[..., d:] == 0).all()), name


@pytest.mark.parametrize("d", [16, 32, 33, 64, 65, 128, 129, 160, 256,
                               257, 320])
def test_kernel_head_dim(d):
    """D up to 256 takes the next instance; past it, the column-chunked
    kernels at D rounded up to a multiple of CHUNK_D (257 and 320 at 384)."""
    if d > 256:
        assert pflash.CHUNK_D == 128
        assert pflash._kernel_head_dim(d) == 384
        assert pflash._head_dim_plan(d) == (384, "chunked")
    else:
        want = next(h for h in pflash.HEAD_DIMS if d <= h)
        assert pflash._kernel_head_dim(d) == want
        assert pflash._head_dim_plan(d) == (want, "instance")


@pytest.mark.parametrize("d,want", [(384, 384), (385, 512), (512, 512),
                                    (1000, 1024), (4096, 4096)])
def test_head_dim_plan_past_256_is_chunked(d, want):
    """Every head dim past 256 has a kernel: the chunked route at the next
    multiple of 128, which the wrappers' checks accept; zero or a negative
    head dim is refused."""
    plan = pflash._head_dim_plan(d)
    assert plan.d == want and plan.route == "chunked"
    with pytest.raises(ValueError, match="positive"):
        pflash._head_dim_plan(0)


def _masked_bias(sq, sk):
    """(1, Sq, Sk): the first rows and every 7th carry -1e9 on every key,
    every 5th past its third key (the card tests' "masked" kind)."""
    bias = np.zeros((1, sq, sk), np.float32)
    bias[0, 4::5, 3:] = -1e9
    bias[0, :4, :] = -1e9
    bias[0, ::7, :] = -1e9
    return bias


@pytest.mark.parametrize("d", [320, 512])
def test_flash_attention_past_256_matches_jax(d):
    """flash_attention at D 320 and 512 (the chunked kernels' route on the
    card, padded to 384 and 512), fp32, causal, dropout 0.1 and the
    "masked" bias, with its gradients, against the JAX package at the
    tolerances of the D 48 / 96 cases.  The JAX gradients come from its
    ``backward="xla"``: its kernel route rebuilds P from lse alone, wrong on
    the rows whose every visible key carries -1e9.

    Causal row 0 sees one key, so its softmax is constant and its dq is 0
    in exact arithmetic; the recompute forms it as P (dP - delta), the
    difference of two D-long fp32 sums of the same products (dO v^T and
    rowsum(dO O)) in other orders.  That row's dq is held to the standard
    bound of that difference, D 2^-24 sum_i |dO_i v_i| / (1 - rate) times
    |k|, and every other element to the D 48 / 96 tolerance."""
    q, k, v, _ = _inputs(1, 2, 24, 24, d, "zeros", seed=d)
    bias = _masked_bias(24, 24)
    do = _dout(q.shape, seed=d + 1)
    seed, causal, rate = 13, True, 0.1

    def jloss(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, jnp.asarray(bias), seed,
                                     causal, rate, 2, "xla")
        return jnp.sum(out * jnp.asarray(do))

    j_out = jflash.flash_attention(*(jnp.asarray(a) for a in (q, k, v,
                                                               bias)),
                                   seed, causal, rate, 2)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = pflash.flash_attention(*qkv, torch.from_numpy(bias), seed=seed,
                                 causal=causal, dropout_rate=rate, heads=2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL, rtol=TOL)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    dq, rdq = got[0].numpy(), np.asarray(ref[0])
    slack = d * 2.0 ** -24 * (np.abs(do[:, 0]) * np.abs(v[:, 0])).sum(
        -1, keepdims=True) / (1 - rate) * np.abs(k[:, 0])
    assert (np.abs(dq[:, 0] - rdq[:, 0]) <= slack).all()
    np.testing.assert_allclose(dq[:, 1:], rdq[:, 1:], atol=BWD_TOL,
                               rtol=BWD_TOL, err_msg="dq")
    for name, a, r in zip(("dk", "dv"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BWD_TOL,
                                   rtol=BWD_TOL, err_msg=name)


@pytest.mark.parametrize("d", [48, 96])
def test_flash_attention_odd_head_dims_match_jax(d):
    """flash_attention at a head dim the kernels are not built for, with
    its gradients, against the JAX package (which computes at any D)."""
    q, k, v, bias = _inputs(2, 2, 24, 24, d, "key_pad", seed=d)
    do = _dout(q.shape, seed=d + 1)
    seed, causal, rate = 11, True, 0.1

    def jloss(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, jnp.asarray(bias), seed,
                                     causal, rate, 2)
        return jnp.sum(out * jnp.asarray(do))

    j_out = jflash.flash_attention(*(jnp.asarray(a) for a in (q, k, v,
                                                               bias)),
                                   seed, causal, rate, 2)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = pflash.flash_attention(*qkv, torch.from_numpy(bias), seed=seed,
                                 causal=causal, dropout_rate=rate, heads=2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL, rtol=TOL)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BWD_TOL,
                                   rtol=BWD_TOL, err_msg=name)


def _peak_close(got, ref, tol, name):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref)
    scale = np.maximum(np.abs(ref), min(1.0, float(np.abs(ref).max())))
    assert (err <= tol * scale).all(), (name, float(err.max()))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_all_masked_rows_backward_matches_jax_xla(causal):
    """BH 2, S 8, D 32, fp32, a (1, S, S) bias.  Non-causal: row 0 is -1e9
    everywhere, row 1 past key 3.  Causal: rows 0-3 are -1e9 everywhere, so
    each sees only masked keys (a time mask's first rows).  The forward's
    lse there is -1e9 + log n, whose log n fp32 cannot hold; the port's
    kernel route rebuilds P from (m, log l) and gives autograd of the
    plain forward (the JAX package's ``backward="xla"``) within 1e-4 on
    the peak rule, and so does its fused plain backward given the
    forward's stats, while given the public lse it is far off."""
    bh, s, d = 2, 8, 32
    rng = np.random.default_rng(21)
    q = (rng.standard_normal((bh, s, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    do = _dout(q.shape, seed=22)
    bias = np.zeros((1, s, s), np.float32)
    if causal:
        bias[0, :4, :] = -1e9
    else:
        bias[0, 0, :] = -1e9
        bias[0, 1, 3:] = -1e9

    def jloss(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, jnp.asarray(bias), 0,
                                     causal, 0.0, 1, "xla")
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = pflash.flash_attention(*qkv, torch.from_numpy(bias), seed=0,
                                 causal=causal, dropout_rate=0.0, heads=1,
                                 backward="pallas")
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        _peak_close(a.numpy(), r, 1e-4, name)
    t = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    o, lse, stats = pflash._flash_fwd_res(t[0], t[1], t[2], t[3], causal,
                                          0.0, 0, 1)
    assert torch.equal(o, out.detach())
    np.testing.assert_allclose(lse.numpy(), (stats[..., :1]
                                             + stats[..., 1:]).numpy())
    delta = (t[4] * o).sum(-1, keepdim=True)
    args = (t[0], t[1], t[2], t[3], causal, 0.0, 0, 1)
    fused = pflash._flash_bwd_fused(*args, stats, delta, t[4])
    for name, a, r in zip(("dq", "dk", "dv"), fused, ref):
        _peak_close(a.numpy(), r, 1e-4, name)
    # the public lse alone cannot carry log l on these rows
    old = pflash._flash_bwd_fused(*args, lse, delta, t[4])
    assert max(float(np.abs(a.numpy() - np.asarray(r)).max())
               for a, r in zip(old, ref)) > 1.0


# ---------------------------------------------------------------------------
# The fp32 kernels' 3xTF32 route, modelled on the CPU: why the card check's
# 1e-4 peak rule holds for it, and how the profiler's names map
# ---------------------------------------------------------------------------

def _tf32(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13
    bits' range to the magnitude, then drop them."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, route):
    """``a @ b`` of fp32 operands, summed in fp32: "1x", one TF32 product
    a pair; "3x", a_lo b_hi + a_hi b_lo + a_hi b_hi with x = hi + lo, hi
    and lo TF32 (``csrc/sm90_tf32.cuh``'s ``mma3``)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if route == "1x":
        return _tf32(a) @ _tf32(b)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _attention_fwd_bwd(q, k, v, do, product):
    """out, dq, dk, dv of softmax attention with each of its six matrix
    products taken by ``product`` (the kernels' S, P v, dP, dV, dK, dq)."""
    dt = np.float64 if product is None else np.float32
    if product is None:
        def product(a, b):
            return a.astype(np.float64) @ b.astype(np.float64)
    s = product(q, k.swapaxes(-1, -2)).astype(dt)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(dt)
    out = product(p, v).astype(dt)
    delta = (do.astype(dt) * out).sum(-1, keepdims=True)
    dv = product(p.swapaxes(-1, -2), do)
    ds = (p * (product(do, v.swapaxes(-1, -2)).astype(dt) - delta)).astype(dt)
    return out, product(ds, k), product(ds.swapaxes(-1, -2), q), dv


def test_tf32_split_rounds_to_nearest_and_recombines():
    """hi and lo carry 10 mantissa bits each (13 low bits zero), hi is x
    rounded to nearest at 10 bits, and hi + lo is x within 2^-22 of it:
    what the 3xTF32 products keep of an fp32 operand."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.integers(
        -6, 6, 100_000)).astype(np.float32)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    # to nearest: no 10-bit neighbour of hi lies closer to x
    step = np.ldexp(1.0, np.frexp(hi.astype(np.float64))[1] - 11)
    assert (np.abs(x - hi.astype(np.float64)) <= step / 2 * (1 + 1e-12)).all()
    rel = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22


@pytest.mark.parametrize("q_scale", [1 / 8, 1 / 2, 1.0])
def test_3xtf32_attention_meets_the_card_tolerance(q_scale):
    """The flagship's head (512 queries and keys, D 64, two heads), q at
    1/8 (the model's 1/sqrt(64) pre-scale), 1/2 and 1, from a seed: with
    each of the six products in 3xTF32, out, dq, dk and dv stay within
    the card check's 1e-4 of float64 on the peak rule, and within 4x of
    plain fp32's distance (plus 1e-6); with one TF32 product a pair every
    one of them misses 1e-4 by 2x or more.  The fp32 kernels are held to
    their plain fp32 versions at 1e-4 on the card with TF32 off
    (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``): this is why
    that limit holds for the 3xTF32 route and would not for TF32 alone."""
    rng = np.random.default_rng(int(q_scale * 8))
    q = (rng.standard_normal((2, 512, 64)) * q_scale).astype(np.float32)
    k, v, do = (rng.standard_normal((2, 512, 64)).astype(np.float32)
                for _ in range(3))
    exact = _attention_fwd_bwd(q, k, v, do, None)

    def peak_err(route):
        if route == "fp32":
            def product(a, b):
                return np.asarray(a, np.float32) @ np.asarray(b, np.float32)
        else:
            def product(a, b):
                return _tf32_product(a, b, route)
        got = _attention_fwd_bwd(q, k, v, do, product)
        errs = []
        for g, r in zip(got, exact):
            a = np.abs(r)
            errs.append(float((np.abs(g - r) / np.maximum(
                a, min(1.0, float(a.max())))).max()))
        return np.array(errs)
    three, one, fp32 = peak_err("3x"), peak_err("1x"), peak_err("fp32")
    assert (three <= 1e-4).all(), three
    assert (three <= 4 * fp32 + 1e-6).all(), (three, fp32)
    assert (one >= 2e-4).all(), one


@pytest.mark.parametrize("d", [32, 64, 128])
def test_launch_name_maps_the_tf32_kernels(d):
    """The profiler's demangled names of the 3xTF32 kernels, with their
    template arguments, map to the launch names their wrappers count: the
    forward at either CTA size, the key-major kernel by its last template
    argument (kEmitDq) to the fused backward or the split route's dk/dv."""
    from apex_tpu_torch.utils import build
    ns, params = "(anonymous namespace)", "((anonymous namespace)::Params)"
    for w in (4, 8):
        name = f"void {ns}::flash_fwd_tf32_kernel<{d}, {w}>{params}"
        assert build.launch_name(name) == "flash_fwd"
        assert build.is_port_kernel(name)
    for emit, want in (("true", "flash_bwd"), ("false", "flash_bwd_dkv")):
        name = f"void {ns}::flash_bwd_kv_tf32_kernel<{d}, {emit}>{params}"
        assert build.launch_name(name) == want
    # the scalar kernels keep D = 256
    assert build.launch_name(
        f"void {ns}::flash_bwd_simt_kernel<float, 256, true>{params}") \
        == "flash_bwd"
