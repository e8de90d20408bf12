"""The port's tensor parallelism (Megatron column / row splits) against the
JAX package's tp placement, transformer and serving engine.

- ``transformer_pspecs`` names, leaf for leaf, the dim JAX's
  ``PartitionSpec`` tree shards over ``model``; ``plan_param_pspecs`` /
  ``serve_shardings`` / ``Plan.pspecs`` give it at tp > 1.
- ``tp_shard_params``: each rank's q / k / v heads (``qkv_heads`` of its
  shards) equal the dense model's heads of that rank, and
  ``tp_gather_params`` inverts the split.
- At world 2 on spawned gloo ranks (``tests/_torch_parallel.py``
  ``tp_cases``), from the JAX weights: the vocab-split embedding, the tied
  head and the vocab-parallel cross-entropy (smoothing 0 and 0.1) equal
  the dense ones forward and backward within 1e-5 (the dense ones: JAX's
  ``_embed``-equivalent port path, ``softmax_xentropy_loss``); the model's
  loss within 1e-6 relative and its gathered gradients within 2e-5 of
  ``jax.grad`` of ``transformer_loss``; ``copy_to_tp`` /
  ``reduce_from_tp`` pass and sum the cotangents as Megatron's *f* / *g*.
- Serving at tp 2: ``InferenceEngine(mesh=)`` serves the tiny config's
  staggered requests, greedy and sampled, at fp32, bf16 and int8 with the
  unsharded engine's tokens; both ranks' tokens and logits are the same
  bits; its fp32 prefill and decode logits are within the serve parity
  tolerance (1e-4) of the JAX engine's; the pools hold H / tp heads; a
  head count the axis does not divide raises with JAX's message.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jinit
from apex_tpu.models import transformer_loss as jloss
from apex_tpu.models import transformer_pspecs as jpspecs
from apex_tpu.parallel import plan as jplan
from apex_tpu.parallel import spmd as jspmd
from apex_tpu.serve import CacheConfig as JaxCache
from apex_tpu.serve import InferenceEngine as JaxEngine

from apex_tpu_torch.contrib.xentropy import softmax_xentropy_loss
from apex_tpu_torch.models import (TransformerConfig, params_from_jax,
                                   tp_gather_params, tp_shard_params,
                                   transformer_pspecs)
from apex_tpu_torch.models import transformer as tm
from apex_tpu_torch.parallel import Plan, spmd as pspmd
from apex_tpu_torch.utils.pytree import tree_leaves

import _torch_dist
import _torch_parallel

DIMS = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32,
            num_heads=4, d_ff=64)
SERVE = dict(vocab_size=64, max_len=32, num_layers=2, d_model=32,
             num_heads=2, d_ff=64)
CACHE = dict(page_size=8, num_pages=16, max_ctx=32)
TOL = 1e-5
SERVE_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _spec_dim(spec):
    """The dim a JAX spec shards over ``model`` (None: replicated)."""
    dims = [i for i, a in enumerate(spec) if a == "model"]
    return dims[0] if dims else None


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_pspecs_name_the_jax_sharded_dims(tie):
    jt = jpspecs(JaxConfig(**DIMS, tie_embeddings=tie))
    pt = transformer_pspecs(TransformerConfig(**DIMS, tie_embeddings=tie))
    jl = jax.tree_util.tree_leaves_with_path(
        jt, is_leaf=lambda x: isinstance(x, P))
    pl = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_leaves_with_path(pt)}
    assert len(jl) == len(pl)
    for path, spec in jl:
        assert tm.spec_dim(pl[jax.tree_util.keystr(path)]) == \
            _spec_dim(spec), jax.tree_util.keystr(path)
    cfg = TransformerConfig(**DIMS, tie_embeddings=tie)
    assert Plan(dp=2, tp=2).pspecs(cfg) == pt
    assert pspmd.plan_param_pspecs(cfg, Plan(dp=4)) == jax.tree_util \
        .tree_map(lambda _: "replicated", pt)


def test_each_rank_holds_its_own_heads():
    """``wqkv``'s columns are [q | k | v]: each rank's q / k / v are the
    dense model's heads of that rank (a contiguous 3D / tp slice would
    give rank 0 all of q)."""
    cfg = TransformerConfig(**DIMS)
    params = params_from_jax(_np(jinit(jax.random.PRNGKey(1),
                                       JaxConfig(**DIMS))), "cpu")
    params["layers"]["bqkv"] = torch.from_numpy(_rand((2, 96), 4))
    h = torch.from_numpy(_rand((2, 16, 32), 3))
    q, k, v = tm.qkv_heads(h, tm.layer(params, 0), cfg)
    for tp in (2, 4):
        shards = [tp_shard_params(params, cfg, r, tp) for r in range(tp)]
        for r, sh in enumerate(shards):
            lq, lk, lv = tm.qkv_heads(h, tm.layer(sh, 0), cfg)
            heads = slice(r * 4 // tp, (r + 1) * 4 // tp)
            for got, want in ((lq, q), (lk, k), (lv, v)):
                assert got.shape[2] == 4 // tp
                torch.testing.assert_close(got, want[:, :, heads],
                                           rtol=1e-6, atol=1e-6)
        back = tp_gather_params(shards, cfg)
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        tp_shard_params(params, cfg, 0, 3)


def _serve_specs(sampled):
    rng = np.random.default_rng(4)
    return [dict(rid=f"r{i}",
                 prompt=rng.integers(1, SERVE["vocab_size"],
                                     int(rng.integers(3, 21))).tolist(),
                 max_new_tokens=int(rng.integers(5, 9)),
                 temperature=0.8 if sampled else 0.0,
                 top_k=8 if sampled else 0, seed=i) for i in range(6)]


@pytest.fixture(scope="module")
def jax_serve():
    """The JAX fp32 engine on fixed prefills and 3 decode steps (the serve
    test's inputs): the inputs and its logits."""
    params = jinit(jax.random.PRNGKey(0), JaxConfig(**SERVE, causal=True))
    eng = JaxEngine(params, JaxConfig(**SERVE, causal=True,
                                      attn_impl="fast"),
                    cache=JaxCache(**CACHE), olevel="fp32", decode_width=4)
    rng = np.random.default_rng(2)
    W, PPR, S = 4, 4, CACHE["max_ctx"]
    prefills, logits = [], []
    tables = np.zeros((W, PPR), np.int64)
    cur = np.zeros(W, np.int64)
    pos = np.zeros(W, np.int64)
    for w, (plen, pages) in enumerate([(11, [1, 2, 0, 0]),
                                       (7, [3, 4, 0, 0])]):
        tokens = np.zeros(S, np.int64)
        tokens[:plen] = rng.integers(1, SERVE["vocab_size"], plen)
        first, last = eng.prefill(tokens, plen, np.array(pages, np.int32),
                                  seed=w)
        prefills.append((plen, pages, tokens, w))
        logits.append(np.asarray(last))
        tables[w] = pages
        cur[w], pos[w] = int(first), plen
    decode = (cur.copy(), pos.copy(), tables.copy())
    zeros = np.zeros(W, np.int32)
    for _ in range(3):
        tok, lg = eng.decode_step(cur, pos, tables, zeros,
                                  np.zeros(W, np.float32), zeros)
        logits.append(np.asarray(lg))
        cur[:2] = np.asarray(tok)[:2]
        pos[:2] += 1
    return _np(params), prefills, decode, logits


@pytest.fixture(scope="module")
def tp_run(jax_serve, tmp_path_factory):
    serve_params, prefills, decode, _ = jax_serve
    data = dict(
        cfg=DIMS,
        params=_np(jinit(jax.random.PRNGKey(0), JaxConfig(**DIMS))),
        tokens=np.random.default_rng(5).integers(0, 64, (2, 16)),
        cot=_rand((2, 16, 32), 6), h=_rand((2, 16, 32), 7),
        cot_v=_rand((2, 16, 64), 8), logits=_rand((12, 64), 9, 3.0),
        labels=np.r_[np.random.default_rng(10).integers(0, 64, 11), -1],
        g=_rand((12,), 11), a=_rand((3, 5), 12),
        serve_cfg=dict(SERVE, causal=True, attn_impl="fast"),
        serve_params=serve_params, cache=CACHE,
        specs={s: _serve_specs(s) for s in (False, True)},
        prefills=prefills, decode=decode)
    return data, _torch_dist.run_ranks(_torch_parallel.tp_cases, 2,
                                       tmp_path_factory.mktemp("tp"), data)


def _dense(data):
    cfg = TransformerConfig(**data["cfg"])
    params = params_from_jax(data["params"], "cpu")
    for grp in params.values():
        for t in grp.values():
            t.requires_grad_(True)
    return cfg, params


def test_vocab_split_embedding_matches_dense(tp_run):
    data, ranks = tp_run
    cfg, p = _dense(data)
    toks = torch.from_numpy(data["tokens"]).long()
    x = tm.embed(p, toks, p["embed"]["pos"][:16][None], cfg)
    (x * torch.from_numpy(data["cot"])).sum().backward()
    for r, out in enumerate(ranks):
        y, g_tok, g_ln = out["embed"]
        np.testing.assert_allclose(y, x.detach().numpy(), atol=TOL)
        np.testing.assert_allclose(
            g_tok, p["embed"]["tok"].grad.numpy()[r * 32:(r + 1) * 32],
            atol=TOL)
        np.testing.assert_allclose(g_ln, p["embed"]["ln_g"].grad.numpy(),
                                   atol=TOL)


def test_tied_head_matches_dense(tp_run):
    data, ranks = tp_run
    cfg, p = _dense(data)
    h = torch.from_numpy(data["h"]).requires_grad_(True)
    logits = tm.head(p, h, cfg)
    (logits * torch.from_numpy(data["cot_v"])).sum().backward()
    for r, out in enumerate(ranks):
        y, gh, g_tok = out["head"]
        np.testing.assert_allclose(y, logits.detach().numpy(), atol=TOL)
        np.testing.assert_allclose(gh, h.grad.numpy(), atol=TOL)
        np.testing.assert_allclose(
            g_tok, p["embed"]["tok"].grad.numpy()[r * 32:(r + 1) * 32],
            atol=TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_xentropy_matches_dense(tp_run, smoothing):
    data, ranks = tp_run
    z = torch.from_numpy(data["logits"]).requires_grad_(True)
    labels = torch.from_numpy(data["labels"]).long()
    loss = softmax_xentropy_loss(z, labels, smoothing, -1, False, "xla")
    (loss * torch.from_numpy(data["g"])).sum().backward()
    for r, out in enumerate(ranks):
        got, gz = out[("xent", smoothing)]
        np.testing.assert_allclose(got, loss.detach().numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(gz, z.grad.numpy()[:, r * 32:(r + 1) * 32],
                                   atol=TOL)
    assert ranks[0][("xent", smoothing)][0][-1] == 0.0   # the padding row


def test_model_loss_and_gathered_gradients_match_jax(tp_run):
    data, ranks = tp_run
    cfg = TransformerConfig(**data["cfg"])
    toks = jnp.asarray(data["tokens"])
    loss, g = jax.value_and_grad(lambda p: jloss(
        p, {"tokens": toks, "targets": toks}, JaxConfig(**data["cfg"])))(
            jax.tree_util.tree_map(jnp.asarray, data["params"]))
    assert ranks[0]["model"][0] == ranks[1]["model"][0]
    assert abs(ranks[0]["model"][0] - float(loss)) <= 1e-6 * float(loss)
    shards = [jax.tree_util.tree_map(torch.from_numpy, r["model"][1])
              for r in ranks]
    got = tp_gather_params(shards, cfg)
    for (path, want), have in zip(
            jax.tree_util.tree_leaves_with_path(_np(g)), tree_leaves(got)):
        np.testing.assert_allclose(have.numpy(), want, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_conjugate_operators_gradients(tp_run):
    """``reduce_from_tp``'s backward passes the cotangent through;
    ``copy_to_tp``'s sums the ranks' cotangents (ranks scale by 1, 2)."""
    data, ranks = tp_run
    a = data["a"]
    for r, out in enumerate(ranks):
        ga, gb = out["ops"]
        np.testing.assert_allclose(ga, (r + 1) * a, rtol=1e-6)
        np.testing.assert_allclose(gb, np.full_like(a, 3.0))


@pytest.mark.parametrize("olevel", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_tp_engine_serves_the_unsharded_tokens(tp_run, olevel, sampled):
    _, ranks = tp_run
    want = ranks[0][("serve", olevel, sampled, "plain")]
    assert all(st == "done" for st, _ in want.values())
    for out in ranks:
        assert out[("serve", olevel, sampled, "tp")] == want
        assert out[("serve", olevel, sampled, "plain")] == want


@pytest.mark.parametrize("olevel", ["fp32", "bf16", "int8"])
def test_tp_engine_logits_are_the_same_bits_on_both_ranks(tp_run, olevel):
    _, ranks = tp_run
    for a, b in zip(ranks[0][("logits", olevel)],
                    ranks[1][("logits", olevel)]):
        np.testing.assert_array_equal(a, b)


def test_tp_engine_logits_match_the_jax_engine(tp_run, jax_serve):
    _, ranks = tp_run
    want = jax_serve[3]
    got = ranks[0][("logits", "fp32")]
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        rows = slice(None) if i < 2 else slice(0, 2)
        np.testing.assert_allclose(a[rows], b[rows], atol=SERVE_TOL,
                                   rtol=SERVE_TOL, err_msg=str(i))
    assert ranks[0]["pool_shape"] == (2, 16, 8, 1, 16)
    assert ranks[0]["heads_error"] == \
        "num_heads 1 not divisible by model-axis size 2"


def test_serve_shardings_match_jax():
    cfg = TransformerConfig(**SERVE)
    with jplan.Plan(dp=1, tp=2).apply(devices=jax.devices()[:2]) as mesh:
        j = jspmd.serve_shardings(mesh, JaxConfig(**SERVE),
                                  packed={"a": 1})

    class _Mesh:
        shape = {"data": 1, "model": 2}

    p = pspmd.serve_shardings(_Mesh(), cfg, packed={"a": 1})
    assert p["kv"] == "model:3" and _spec_dim(j["kv"].spec) == 3
    assert p["params"] == transformer_pspecs(cfg)
    packed = [1, 2]
    assert pspmd.serve_shardings(_Mesh(), cfg, packed=packed) == {
        "params": ["replicated", "replicated"], "kv": "model:3"}
    with pytest.raises(ValueError, match="not divisible by model-axis"):
        pspmd.serve_shardings(
            _Mesh(), TransformerConfig(**dict(SERVE, num_heads=1)),
            packed={})
