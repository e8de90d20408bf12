"""The port's sequence parallelism against the JAX package's
``parallel.sequence`` on a seq-only mesh.

- ``ring_attention`` and ``ulysses_attention`` at world 1, 2 and 4
  (spawned gloo ranks, ``tests/_torch_parallel.py``; the JAX functions
  inside ``shard_map`` over a mesh of as many CPU devices), causal and
  not: each rank's output block and its q/k/v gradient blocks of
  sum(out * cot) within 2e-5 (outputs) and 5e-5 (gradients) absolute of
  JAX's (fp32; both fold the same blocks in the same order, so what
  differs is summation order).
- ring cross-attention with a kv length twice q's; Ulysses through the
  flash core (``ulysses_flash_attention``, the kernels' plain versions on
  the CPU) against JAX's at world 2.
- ``validate_sp`` / ``SequenceShardingError``: the JAX messages, and the
  ragged-heads error from inside a call.
- ``SelfMultiheadAttn(impl="ring" | "ulysses", seq_inner_impl=...)``, the
  JAX module's weights loaded, on each rank's block of a (T, B, E) input
  at world 2: the output against the JAX module's ``impl="default"`` on
  the whole sequence (with the causal time mask when causal) within 3e-5,
  the input and parameter gradients (summed over ranks) within 1e-4 of
  JAX's.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JSelf
from apex_tpu.parallel.mesh import shard_map
from apex_tpu.parallel import sequence as jseq

from apex_tpu_torch.parallel import sequence as pseq

import _torch_dist
import _torch_parallel

B, H, S, D = 2, 4, 32, 16
FWD, GRAD = 2e-5, 5e-5
E_MHA, H_MHA, T_MHA = 32, 4, 16


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _data():
    qkv = [_arr((B, H, S, D), s) for s in (1, 2, 3)] + [_arr((B, H, S, D),
                                                             4)]
    cross = [_arr((B, H, S, D), 5), _arr((B, H, 2 * S, D), 6),
             _arr((B, H, 2 * S, D), 7), _arr((B, H, S, D), 8)]
    return {"self": qkv, "cross": cross}


JFNS = {"ring": jseq.ring_attention, "ulysses": jseq.ulysses_attention,
        "ulysses_flash": functools.partial(jseq.ulysses_flash_attention,
                                           backward="xla")}


def _jax_case(name, causal, q, k, v, cot, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, None, "seq", None)
    fn = JFNS[name]

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,) * 3,
                       out_specs=spec, check_vma=False)
    def run(q, k, v):
        return fn(q, k, v, axis_name="seq", causal=causal)

    def loss(q, k, v):
        return jnp.sum(run(q, k, v) * cot)

    out = run(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _cases(world):
    cases = [(fn, c, "self", "self") for fn in ("ring", "ulysses")
             for c in (False, True)]
    cases.append(("ring", False, "cross", "cross"))
    if world == 2:
        cases += [("ulysses_flash", c, "self", "self") for c in (False,
                                                                 True)]
    return cases


MHA_CASES = [("ring", "default", False), ("ring", "default", True),
             ("ulysses", "default", True), ("ulysses", "fast", True)]


def _mha_data():
    jm = JSelf(E_MHA, H_MHA, impl="default")
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return {"E": E_MHA, "H": H_MHA, "params": params,
            "x": _arr((T_MHA, B, E_MHA), 9),
            "cot": _arr((T_MHA, B, E_MHA), 10), "cases": MHA_CASES}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["w1", "w2", "w4"])
def world_run(request, tmp_path_factory):
    """Every function case at one world size."""
    world = request.param
    data = _data()
    payload = dict(data, cases=_cases(world),
                   mha=dict(_mha_data(), cases=[]))
    ranks = _torch_dist.run_ranks(_torch_parallel.sequence_cases, world,
                                  tmp_path_factory.mktemp("seq"), payload)
    return world, data, payload, ranks


@pytest.fixture(scope="module")
def mha_run(tmp_path_factory):
    data = _data()
    payload = dict(data, cases=[], mha=_mha_data())
    ranks = _torch_dist.run_ranks(_torch_parallel.sequence_cases, 2,
                                  tmp_path_factory.mktemp("mha"), payload)
    return payload, ranks


def _gather(ranks, key, i, axis):
    return np.concatenate([r[key][i] for r in ranks], axis=axis)


def test_functions_match_jax_forward_and_gradients(world_run):
    world, data, payload, ranks = world_run
    for name, causal, qk, kv in payload["cases"]:
        q, _, _, cot = data[qk]
        _, k, v, _ = data[kv]
        ref = _jax_case(name, causal, q, k, v, cot, world)
        key = (name, causal, qk, kv)
        for i, tol in enumerate((FWD, GRAD, GRAD, GRAD)):
            got = _gather(ranks, key, i, 2)
            np.testing.assert_allclose(got, ref[i], atol=tol, rtol=0,
                                       err_msg=f"{key} output {i}")


def test_functions_match_dense_attention(world_run):
    """The JAX test's own oracle, for the port: plain softmax attention on
    the whole sequence."""
    world, data, payload, ranks = world_run
    for name, causal, qk, kv in payload["cases"]:
        q, _, _, _ = data[qk]
        _, k, v, _ = data[kv]
        s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
        if causal:
            s = np.where(np.tril(np.ones((S, k.shape[2]), bool)), s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        ref = np.einsum("bhqk,bhkd->bhqd", p, v)
        got = _gather(ranks, (name, causal, qk, kv), 0, 2)
        np.testing.assert_allclose(got, ref, atol=FWD, rtol=0)


@pytest.mark.parametrize("impl,inner,causal", MHA_CASES,
                         ids=["ring", "ring-causal", "ulysses-causal",
                              "ulysses-fast-causal"])
def test_mha_modules_match_the_default_module(mha_run, impl, inner, causal):
    payload, ranks = mha_run
    mha = payload["mha"]
    jparams = jax.tree_util.tree_map(jnp.asarray, mha["params"])
    jm = JSelf(E_MHA, H_MHA, impl="default")
    tmask = (jnp.triu(jnp.ones((T_MHA, T_MHA)), 1) > 0) if causal else None

    def loss(p, x):
        out, _ = jm(p, x, attn_mask=tmask, is_training=False)
        return jnp.sum(out * mha["cot"]), out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(mha["x"]))
    key = ("mha", impl, inner, causal)
    out = np.concatenate([r[key][0] for r in ranks], axis=0)
    gx = np.concatenate([r[key][1] for r in ranks], axis=0)
    np.testing.assert_allclose(out, np.asarray(jout), atol=3e-5)
    np.testing.assert_allclose(gx, np.asarray(jgx), atol=1e-4)
    for n, g in jg.items():
        got = sum(r[key][2][n] for r in ranks)
        np.testing.assert_allclose(got, np.asarray(g), atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("seq,heads,sp,strategy", [
    (64, 8, 3, "ring"), (64, 6, 4, "ulysses"), (64, 6, 4, "ring"),
    (64, 8, 1, "ulysses"), (64, 8, 4, "ulysses")])
def test_validate_sp_matches_jax(seq, heads, sp, strategy):
    def outcome(mod):
        try:
            mod.validate_sp(seq, heads, sp, strategy)
            return None
        except mod.SequenceShardingError as e:
            return str(e)
    assert outcome(pseq) == outcome(jseq)


def test_ragged_heads_raise_from_the_call(tmp_path):
    msgs = _torch_dist.run_ranks(_torch_parallel.sequence_errors, 2,
                                 tmp_path)
    for m in msgs:
        assert m is not None and "num_heads 5 does not divide over seq " \
            "axis size 2" in m
    assert issubclass(pseq.SequenceShardingError, ValueError)
