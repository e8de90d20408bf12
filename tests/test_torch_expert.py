"""The port's expert parallelism and MoE transformer against the JAX
package's ``parallel.expert`` and ``models.moe_transformer``.

- ``_one_hot_dispatch``: dispatch, combine and the aux loss bit for bit
  against JAX's on the same logits, argmax ties and capacity overflow
  included (the queue positions are an exact prefix count in both).
- ``moe_ffn`` at ep 1, 2 and 4 (spawned gloo ranks over an ``expert``
  mesh, ``tests/_torch_parallel.py``), each rank routing its own token
  block over its expert shard, at capacity factors 8 (no drops), 1.25 and
  0.25 (overflow): outputs within 2e-5 of JAX's ``moe_ffn`` inside
  ``shard_map`` over as many CPU devices, the aux losses within 1e-6
  relative, and the gradients of sum(out * cot) + aux (tokens, router
  summed over ranks, each rank's expert shard) within 5e-5 absolute of the
  JAX per-shard oracle (single-device MoE on each token block, the JAX
  test's).  Each exchange, forward and backward, is metered: 4 ``ep.
  all_to_all`` calls of the (E_total * capacity, D) fp32 queue.
- the MoE model: loss and gradients of the port's ``moe_transformer_loss``
  from the JAX weights (``moe_params_from_jax``) against JAX's, with
  ``attn_impl`` "default" and "fast" (the kernels' plain versions on the
  CPU), remat off and on: the loss within 1e-6 relative, gradients within
  5e-5 absolute; expert-sharded at world 2 against JAX's loss summed over
  the two token blocks.
- the dp-MoE twin on a fresh seeded batch each step (the JAX MoE test's
  config, lr 1e-4, 5 steps): the port's losses within 1e-5 relative of
  the JAX ep engine's at every step; in both a later step's loss
  exceeds step 0's.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models.moe_transformer import (MoETransformerConfig as JCfg,
                                             moe_transformer_init as jinit,
                                             moe_transformer_loss as jloss)
from apex_tpu.parallel import expert as jexp
from apex_tpu.parallel.mesh import shard_map

from apex_tpu_torch.models import (MoETransformerConfig,
                                   moe_params_from_jax,
                                   moe_transformer_init,
                                   moe_transformer_loss)
from apex_tpu_torch.parallel import MoELayer
from apex_tpu_torch.parallel import expert as pexp

import _torch_dist
import _torch_parallel

T, D, F, E = 64, 16, 32, 8
CFS = {"wide": 8.0, "switch": 1.25, "overflow": 0.25}
MODEL = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32,
             num_heads=2, d_ff=64, num_experts=4)


def _arr(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# -- the dispatch ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "ties", "overflow"])
def test_one_hot_dispatch_is_bit_equal(kind):
    rng = np.random.default_rng(3)
    if kind == "ties":      # few distinct logits: many exact argmax ties
        logits = rng.integers(0, 3, (T, E)).astype(np.float32)
    else:
        logits = rng.standard_normal((T, E)).astype(np.float32)
    if kind == "overflow":
        logits[:, 2] += 4.0                      # most tokens -> expert 2
    cap = 3 if kind != "random" else 10
    jd, jc, ja = jexp._one_hot_dispatch(jnp.asarray(logits), E, cap)
    pd, pc, pa = pexp._one_hot_dispatch(torch.from_numpy(logits), E, cap)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert float(pa) == float(ja)
    with pytest.raises(ValueError, match="router width"):
        pexp._one_hot_dispatch(torch.from_numpy(logits), E + 1, cap)


# -- moe_ffn over ranks --------------------------------------------------------------

def _ffn_data():
    out = {}
    for i, (name, cf) in enumerate(CFS.items()):
        out[name] = {"x": _arr((T, D), 10 + i),
                     "router": _arr((D, E), 20 + i, 0.5),
                     "w_in": _arr((E, D, F), 30 + i, (2.0 / D) ** 0.5),
                     "w_out": _arr((E, F, D), 40 + i, (1.0 / F) ** 0.5),
                     "cot": _arr((T, D), 50 + i), "cf": cf}
    return out


def _jax_ffn(case, n):
    """(sharded out, per-shard aux list, oracle grads)."""
    cf = case["cf"]
    x, r = jnp.asarray(case["x"]), jnp.asarray(case["router"])
    wi, wo = jnp.asarray(case["w_in"]), jnp.asarray(case["w_out"])
    cot = jnp.asarray(case["cot"])
    mesh = Mesh(np.array(jax.devices()[:n]), ("expert",))
    spec = (P(), P("expert"), P("expert"))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P("expert"),) + spec,
                       out_specs=(P("expert"), P("expert")), check_vma=False)
    def sharded(x, r, wi, wo):
        out, aux = jexp.moe_ffn(x, r, wi, wo, axis_name="expert",
                                capacity_factor=cf)
        return out, aux[None]

    def oracle(x, r, wi, wo):
        total, auxes = 0.0, []
        for xs, cs in zip(x.reshape(n, T // n, D), cot.reshape(n, T // n,
                                                               D)):
            o, a = jexp.moe_ffn(xs, r, wi, wo, axis_name=None,
                                capacity_factor=cf)
            total = total + jnp.sum(o * cs) + a
            auxes.append(a)
        return total, auxes

    out, aux = sharded(x, r, wi, wo)
    grads = jax.grad(lambda *a: oracle(*a)[0], argnums=(0, 1, 2, 3))(
        x, r, wi, wo)
    return (np.asarray(out), np.asarray(aux),
            [np.asarray(g) for g in grads])


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["ep1", "ep2", "ep4"])
def ffn_run(request, tmp_path_factory):
    n = request.param
    data = {"ffn": _ffn_data()}
    ranks = _torch_dist.run_ranks(_torch_parallel.expert_cases, n,
                                  tmp_path_factory.mktemp("ep"), data)
    return n, data, ranks


@pytest.fixture(scope="module")
def model_run(tmp_path_factory):
    data = {"ffn": {}, "model": _model_data()}
    ranks = _torch_dist.run_ranks(_torch_parallel.expert_cases, 2,
                                  tmp_path_factory.mktemp("moe"), data)
    return data, ranks


@pytest.mark.parametrize("name", list(CFS))
def test_moe_ffn_matches_jax(ffn_run, name):
    n, data, ranks = ffn_run
    case = data["ffn"][name]
    out, aux, (gx, gr, gwi, gwo) = _jax_ffn(case, n)
    np.testing.assert_allclose(np.concatenate([r[name][0] for r in ranks]),
                               out, atol=2e-5)
    np.testing.assert_allclose([r[name][1] for r in ranks], aux, rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([r[name][2] for r in ranks]),
                               gx, atol=5e-5)
    np.testing.assert_allclose(sum(r[name][3] for r in ranks), gr, atol=5e-5)
    np.testing.assert_allclose(np.concatenate([r[name][4] for r in ranks]),
                               gwi, atol=5e-5)
    np.testing.assert_allclose(np.concatenate([r[name][5] for r in ranks]),
                               gwo, atol=5e-5)
    if name == "overflow":       # tokens past capacity get no expert output
        cap = max(int(case["cf"] * (T // n) / E), 1)
        rows = np.abs(np.concatenate([r[name][0] for r in ranks])).sum(1)
        assert (rows > 0).sum() <= n * E * cap < T


@pytest.mark.parametrize("name", list(CFS))
def test_moe_ffn_meters_each_exchange(ffn_run, name):
    n, data, ranks = ffn_run
    cap = max(int(data["ffn"][name]["cf"] * (T // n) / E), 1)
    for r in ranks:
        meters = r[name][6]              # bound at ep 1 too: a copy
        assert meters["ep.all_to_all_calls"] == 4
        assert meters["ep.all_to_all_bytes"] == 4 * (E * cap * D * 4)
        assert meters["ep.all_to_all_compressed_bytes"] == \
            meters["ep.all_to_all_bytes"]


def test_moe_layer_init_and_shard_validation():
    layer = MoELayer(d_model=D, d_ff=F, num_experts=E, n_shards=4)
    p = layer.init(torch.Generator().manual_seed(0), device="cpu")
    assert p["w_in"].shape == (2, D, F) and p["w_out"].shape == (2, F, D)
    assert p["router"].shape == (D, E)
    # unbound (no mesh): single-device MoE over all the experts
    whole = MoELayer(d_model=D, d_ff=F, num_experts=E)
    out, aux = whole(whole.init(torch.Generator().manual_seed(0),
                                device="cpu"), torch.ones(2, 3, D))
    assert out.shape == (2, 3, D) and aux.dim() == 0
    with pytest.raises(ValueError, match="router width 8 != expert count 2"):
        layer(p, torch.ones(2, 3, D))
    with pytest.raises(ValueError, match="must divide"):
        MoELayer(d_model=D, d_ff=F, num_experts=E, n_shards=3).init(
            torch.Generator(), device="cpu")


# -- the MoE model ---------------------------------------------------------------------

def _model_data():
    jcfg = JCfg(**MODEL)
    params = jax.tree_util.tree_map(np.asarray,
                                    jinit(jax.random.PRNGKey(4), jcfg))
    tokens = np.random.default_rng(5).integers(0, MODEL["vocab_size"],
                                               (4, MODEL["max_len"]))
    return {"cfg": MODEL, "params": params, "tokens": tokens.astype(np.int32)}


def _jax_loss_grads(params, tokens, **kw):
    cfg = JCfg(**MODEL, **kw)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(tokens)}
    loss, g = jax.value_and_grad(lambda p: jloss(p, batch, cfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


def _port_loss_grads(params_np, tokens, **kw):
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    cfg = MoETransformerConfig(**MODEL, **kw)
    leaves, td = tree_flatten(moe_params_from_jax(params_np, "cpu"))
    leaves = [p.requires_grad_(True) for p in leaves]
    toks = torch.from_numpy(tokens.astype(np.int64))
    loss = moe_transformer_loss(tree_unflatten(td, leaves),
                                {"tokens": toks, "targets": toks}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), tree_unflatten(td, [g.numpy()
                                                     for g in grads])


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("attn_impl,remat", [
    ("default", False), ("fast", False), ("default", True), ("fast", True)])
def test_moe_model_matches_jax(attn_impl, remat):
    data = _model_data()
    jl, jg = _jax_loss_grads(data["params"], data["tokens"],
                             attn_impl=attn_impl, remat=remat)
    pl, pg = _port_loss_grads(data["params"], data["tokens"],
                              attn_impl=attn_impl, remat=remat)
    assert abs(pl - jl) <= 1e-6 * abs(jl)
    for a, b in zip(_leaves(pg), _leaves(jg)):
        np.testing.assert_allclose(a, b, atol=5e-5)


def test_moe_model_expert_sharded_matches_jax(model_run):
    data, ranks = model_run
    model = data["model"]
    half = model["tokens"].shape[0] // 2
    parts = [_jax_loss_grads(model["params"], model["tokens"][i * half:
                                                            (i + 1) * half])
             for i in range(2)]
    got = [r["model"] for r in ranks]
    for (jl, _), (pl, _) in zip(parts, got):
        assert abs(pl - jl) <= 1e-6 * abs(jl)
    jg = jax.tree_util.tree_map(lambda a, b: a + b, parts[0][1], parts[1][1])
    e_local = MODEL["num_experts"] // 2
    for i, lyr in enumerate(jg["layers"]):
        for k, g in lyr.items():
            if k in ("w_in", "w_out"):
                got_g = np.concatenate([r["model"][1]["layers"][i][k]
                                        for r in ranks])
                assert got_g.shape[0] == 2 * e_local
            else:
                got_g = sum(r["model"][1]["layers"][i][k] for r in ranks)
            np.testing.assert_allclose(got_g, g, atol=5e-5, err_msg=k)
    for k in ("head_ln_g", "head_ln_b"):
        np.testing.assert_allclose(sum(r["model"][1][k] for r in ranks),
                                   jg[k], atol=5e-5)


def test_moe_init_shapes_and_validation():
    cfg = MoETransformerConfig(**MODEL)
    p = moe_transformer_init(cfg, torch.Generator().manual_seed(0),
                             n_expert_shards=2, device="cpu")
    j = jinit(jax.random.PRNGKey(0), JCfg(**MODEL), n_expert_shards=2)
    from apex_tpu_torch.utils.pytree import tree_flatten
    assert [tuple(l.shape) for l in tree_flatten(p)[0]] == \
        [tuple(l.shape) for l in jax.tree_util.tree_leaves(j)]
    with pytest.raises(ValueError):
        moe_transformer_init(cfg, torch.Generator(), n_expert_shards=3,
                             device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        moe_transformer_loss(p, {"tokens": torch.zeros(1, 4).long(),
                                 "targets": torch.zeros(1, 4).long()},
                             dataclasses.replace(cfg, attn_impl="bogus"))


# -- the MoE step on fresh batches ------------------------------------------------

FRESH_CFG = dict(vocab_size=256, max_len=32, num_layers=2, d_model=32,
                 num_heads=4, d_ff=64, num_experts=8, capacity_factor=8.0)
FRESH_STEPS, FRESH_GB, FRESH_LR = 5, 8, 1e-4


def _fresh_tokens(step):
    return np.random.default_rng(100 + step).integers(
        0, FRESH_CFG["vocab_size"], (FRESH_GB, FRESH_CFG["max_len"]))


def _port_fresh_losses(rank, world, params_np):
    from apex_tpu_torch.parallel import Plan, create_mesh, spmd
    cfg = MoETransformerConfig(**FRESH_CFG)
    mesh = create_mesh({"data": 1})
    carry, step, _ = spmd._build_ep_step(
        cfg, mesh, Plan(dp=1), FRESH_GB, FRESH_LR, False,
        moe_params_from_jax(params_np, "cpu"), 0, torch.device("cpu"))
    losses = []
    for i in range(FRESH_STEPS):
        carry, loss = step(carry, torch.from_numpy(_fresh_tokens(i)))
        losses.append(float(loss))
    return losses


def test_moe_step_on_fresh_batches_matches_jax(tmp_path):
    """The dp-MoE twin (the ep engine at ep 1) on a fresh seeded batch of
    uniform tokens each step at lr 1e-4, the JAX MoE test's config: the
    port's losses equal the JAX engine's (``spmd._build_ep_step`` on a
    data-only mesh) within 1e-5 relative at every step, and in both a
    later step's loss exceeds step 0's: uniform tokens carry nothing to
    learn, so on fresh batches the loss follows the batches, not the
    port."""
    from apex_tpu.parallel import plan as jplan
    from apex_tpu.parallel import spmd as jspmd
    jcfg = JCfg(**FRESH_CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    jinit(jax.random.PRNGKey(0), jcfg))
    with jplan.Plan(dp=1).apply(devices=jax.devices()[:1]) as mesh:
        carry, step, _ = jspmd._build_ep_step(jcfg, mesh, jplan.Plan(dp=1),
                                              FRESH_GB, FRESH_LR, False)
        ref = []
        for i in range(FRESH_STEPS):
            carry, loss = step(carry, jnp.asarray(_fresh_tokens(i),
                                                  jnp.int32))
            ref.append(float(loss))
    got = _torch_dist.run_in_process(_port_fresh_losses, tmp_path, params)
    print("MoE fresh batches: port", got, "jax", ref)
    for a, b in zip(got, ref):
        assert abs(a - b) <= 1e-5 * abs(b), (got, ref)
    assert max(got[1:]) > got[0] and max(ref[1:]) > ref[0]
