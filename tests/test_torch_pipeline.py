"""The port's pipeline parallelism against the JAX package's
``parallel.pipeline``.

``pipeline_apply`` of a tanh stage at S = 2 and 4 stages (spawned gloo
ranks, ``tests/_torch_parallel.py``) with M = 1, 2, 3 and 4 microbatches,
against the JAX ``pipeline_apply`` inside ``shard_map`` over a mesh of S
CPU devices and against the stages run one after another (the JAX test's
oracle): the output on every rank within 1e-5, each stage's weight and
bias gradients and the input's gradient (summed over ranks) of sum(out *
cot) within 1e-5 absolute (fp32; the same products in the same order).
``unstack_local`` refuses a multi-stage slice with the JAX message.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel.mesh import shard_map
from apex_tpu.parallel.pipeline import (pipeline_apply, stack_stage_params,
                                        unstack_local)

import _torch_dist
import _torch_parallel

M_MAX, B, D = 4, 4, 16
MS = (1, 2, 3, 4)
TOL = 1e-5


def _stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _data(n):
    rng = np.random.default_rng(n)
    return {"w": [0.5 * rng.standard_normal((D, D)).astype(np.float32)
                  for _ in range(n)],
            "b": [0.01 * np.ones(D, np.float32) + 0.01 * i
                  for i in range(n)],
            "x": rng.standard_normal((M_MAX, B, D)).astype(np.float32),
            "cot": rng.standard_normal((M_MAX, B, D)).astype(np.float32),
            "ms": MS}


def _jax(data, n, m):
    stages = [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
              for w, b in zip(data["w"], data["b"])]
    stacked = stack_stage_params(stages)
    x = jnp.asarray(data["x"][:m])
    cot = jnp.asarray(data["cot"][:m])
    mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
    pspec = jax.tree_util.tree_map(lambda _: P("pipe"), stacked)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(pspec, P()),
                       out_specs=P(), check_vma=False)
    def run(s, x):
        return pipeline_apply(_stage_fn, unstack_local(s), x)

    def seq(s, x):
        h = x
        for i in range(n):
            p = jax.tree_util.tree_map(lambda l: l[i], s)
            h = jax.vmap(lambda xb: _stage_fn(p, xb))(h)
        return h

    out = run(stacked, x)
    ref = seq(stacked, x)
    g_pipe = jax.grad(lambda s, x: jnp.sum(run(s, x) * cot),
                      argnums=(0, 1))(stacked, x)
    g_seq = jax.grad(lambda s, x: jnp.sum(seq(s, x) * cot),
                     argnums=(0, 1))(stacked, x)
    tonp = functools.partial(jax.tree_util.tree_map, np.asarray)
    return tonp(out), tonp(ref), tonp(g_pipe), tonp(g_seq)


@pytest.fixture(scope="module", params=[2, 4], ids=["s2", "s4"])
def stages_run(request, tmp_path_factory):
    n = request.param
    data = _data(n)
    ranks = _torch_dist.run_ranks(_torch_parallel.pipeline_cases, n,
                                  tmp_path_factory.mktemp("pipe"), data)
    return n, data, ranks


@pytest.mark.parametrize("m", MS)
def test_output_matches_jax_and_the_sequential_stages(stages_run, m):
    n, data, ranks = stages_run
    out, ref, _, _ = _jax(data, n, m)
    np.testing.assert_allclose(out, ref, atol=TOL)
    for r in ranks:                       # replicated on every rank
        np.testing.assert_allclose(r[m][0], out, atol=TOL)
        np.testing.assert_allclose(r[m][0], ref, atol=TOL)


@pytest.mark.parametrize("m", MS)
def test_gradients_match_the_sequential_stages(stages_run, m):
    n, data, ranks = stages_run
    _, _, g_pipe, g_seq = _jax(data, n, m)
    (gs_seq, gx_seq), (gs_pipe, gx_pipe) = g_seq, g_pipe
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r[m][1], gs_seq["w"][i], atol=TOL)
        np.testing.assert_allclose(r[m][2], gs_seq["b"][i], atol=TOL)
        np.testing.assert_allclose(r[m][1], gs_pipe["w"][i], atol=TOL)
    gx = sum(r[m][3] for r in ranks)
    np.testing.assert_allclose(gx, gx_seq, atol=TOL)
    np.testing.assert_allclose(gx, gx_pipe, atol=TOL)


def test_unstack_local_refuses_a_multi_stage_slice(stages_run):
    _, _, ranks = stages_run
    try:
        unstack_local({"w": jnp.zeros((2, 3))})
        want = None
    except ValueError as e:
        want = str(e)
    for r in ranks:
        assert r["unstack_error"] == want is not None
