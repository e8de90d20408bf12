"""The port's overlapped DDP reduction against the JAX package's
``parallel.overlap``.

- :func:`partition_buckets` gives the JAX layout: the same leaf ids per
  bucket and, with paths and dtypes spelled the JAX way, the same
  ``signature``; :func:`shard_chunk_bounds`, :func:`resolve_mode` (explicit
  > ``APEX_TPU_OVERLAP`` > off), :func:`can_stream` and :func:`warn_once`
  answer as the JAX ones do.
- The hooked backward (:meth:`DistributedDataParallel.grad` under
  ``overlap="bucketed"``) on a tiny transformer with remat and the tied
  embedding, world 2 on spawned gloo ranks (``tests/_torch_dist.py``):
  every leaf's hook fires once, with the leaf's total gradient; the buckets
  are JAX's ``partition_buckets`` and launch in its order, bucket 0 before
  the last hook; the reduced gradients are bitwise
  :meth:`~DistributedDataParallel.allreduce_grads` of the plain backward's
  gradients, fp32 and int8 (with the error-feedback residual) alike; and
  they agree with the mean of the JAX package's per-rank gradients of the
  same weights and batches to 1e-5 of the largest (two frameworks' fp32
  products).
- The DDP train steps take the hooked form: ``resnet_train_step`` and
  ``simple_ddp_train_step`` under ``bucketed`` give the bits of ``off``.

The bucketed reduction of existing gradients and the zero1 chunked forms
are held to the JAX package in ``tests/test_torch_collectives.py``.
"""
import os
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import TransformerConfig as JaxCfg
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.models import transformer_loss as jax_loss
from apex_tpu.parallel import overlap as jov

import _torch_dist
from _torch_port import amp_uninit  # noqa: F401
from apex_tpu_torch.parallel import DistributedDataParallel
from apex_tpu_torch.parallel import overlap as tov

CFG = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=2,
           d_ff=64, remat=True)


@pytest.fixture(autouse=True)
def _clean_env():
    prev = os.environ.pop(tov.ENV_KNOB, None)
    yield
    os.environ.pop(tov.ENV_KNOB, None)
    if prev is not None:
        os.environ[tov.ENV_KNOB] = prev


def _trees():
    rng = np.random.default_rng(0)
    return [
        {"a": np.zeros((3, 5), np.float32), "b": np.zeros(7, np.float32),
         "c": {"z": np.zeros((40, 40), np.float32),
               "y": [np.zeros(3, np.float32), np.zeros((2, 2), np.float32)]},
         "d": np.zeros(600, np.float32)},
        {k: rng.standard_normal(s).astype(np.float32)
         for k, s in (("w1", (64, 32)), ("b1", (32,)), ("w2", (32, 8)))},
    ]


@pytest.mark.parametrize("tree_i", [0, 1])
@pytest.mark.parametrize("message_size", [1, 40, 700, 10_000_000])
@pytest.mark.parametrize("reverse", [True, False])
def test_partition_buckets_is_the_jax_layout(tree_i, message_size,
                                             reverse):
    tree = _trees()[tree_i]
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    ref = jov.partition_buckets(jt, message_size=message_size,
                                reverse=reverse)
    got = tov.partition_buckets(tt, message_size=message_size,
                                reverse=reverse)
    assert [b.leaf_ids for b in got.buckets] == \
        [b.leaf_ids for b in ref.buckets]
    assert [b.paths for b in got.buckets] == [b.paths for b in ref.buckets]
    assert [(b.elems, b.nbytes) for b in got.buckets] == \
        [(b.elems, b.nbytes) for b in ref.buckets]
    assert got.signature == ref.signature
    assert (got.num_leaves, got.message_size) == (ref.num_leaves,
                                                  ref.message_size)


def test_signature_reads_dtypes_and_bf16_matches_jax():
    jt = {"w": jnp.zeros((4, 4), jnp.bfloat16), "b": jnp.zeros(4)}
    tt = {"w": torch.zeros(4, 4, dtype=torch.bfloat16), "b": torch.zeros(4)}
    assert tov.partition_buckets(tt, message_size=8).signature == \
        jov.partition_buckets(jt, message_size=8).signature
    tt["w"] = tt["w"].float()
    assert tov.partition_buckets(tt, message_size=8).signature != \
        jov.partition_buckets(jt, message_size=8).signature
    with pytest.raises(ValueError):
        tov.partition_buckets(tt, message_size=0)


@pytest.mark.parametrize("per,msize,align", [
    (1024, 128, 128), (1024, 300, 128), (1000, 128, 128), (0, 5, 128),
    (4096, 10_000, 128), (3072, 1000, 384)])
def test_shard_chunk_bounds_match_jax(per, msize, align):
    assert tov.shard_chunk_bounds(per, msize, align) == \
        jov.shard_chunk_bounds(per, msize, align)


def test_modes_env_and_streaming_match_jax():
    assert tov.MODES == jov.MODES and tov.ENV_KNOB == jov.ENV_KNOB
    assert tov.DEFAULT_MESSAGE_SIZE == jov.DEFAULT_MESSAGE_SIZE
    assert tov.resolve_mode() == "off"
    os.environ[tov.ENV_KNOB] = " Bucketed "
    assert tov.resolve_mode() == jov.resolve_mode() == "bucketed"
    assert tov.resolve_mode("off") == "off"
    os.environ[tov.ENV_KNOB] = "sometimes"
    with pytest.raises(ValueError):
        tov.resolve_mode()
    del os.environ[tov.ENV_KNOB]
    for scheme in (None, "fp32", "bf16", "int8_blockscale", "adasum",
                   "adasum:block=64", lambda p, l: None):
        assert tov.can_stream(scheme) == jov.can_stream(scheme), scheme
    with pytest.warns(UserWarning, match="once"):
        tov.warn_once(("test", 1), "once")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tov.warn_once(("test", 1), "once")


def test_bucketed_allreduce_refuses_what_cannot_stream():
    g = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="callable"):
        tov.bucketed_allreduce(g, scheme=lambda p, l: None)
    with pytest.raises(ValueError, match="adasum"):
        tov.bucketed_allreduce(g, scheme="adasum")
    assert tov.bucketed_allreduce(g) is g          # no group: the identity


def test_ddp_mode_resolution_and_fallbacks():
    with pytest.warns(UserWarning, match="pins the deferred path"):
        ddp = DistributedDataParallel(overlap="bucketed",
                                      delay_allreduce=True, device="cpu")
    assert ddp.mode() == "off"
    os.environ[tov.ENV_KNOB] = "bucketed"
    assert DistributedDataParallel(device="cpu").mode() == "bucketed"
    assert DistributedDataParallel(overlap="off", device="cpu").mode() \
        == "off"
    ddp = DistributedDataParallel(collective_scheme="adasum", device="cpu")
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert ddp.mode() == "off"


# -- the hooked backward at world 2 ----------------------------------------------

def _jax_params():
    cfg = JaxCfg(**CFG, dtype=jnp.float32)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(3), cfg))


def _tokens(world):
    return np.random.default_rng(5).integers(0, 64, (2 * world, 16))


@pytest.fixture(scope="module")
def hooked(tmp_path_factory):
    _, params = _jax_params()
    return _torch_dist.run_ranks(
        _torch_dist.hooked_grad_cases, 2, tmp_path_factory.mktemp("hook"),
        params, _tokens(2), {k: v for k, v in CFG.items()})


@pytest.mark.parametrize("mode", ["off", "bucketed", "bucketed_int8",
                                  "off_int8"])
def test_hooked_grads_are_allreduce_grads_bits(hooked, mode):
    for res in hooked:
        assert res[mode]["same_as_allreduce_grads"]
        assert res[mode]["same_residual"]
    np.testing.assert_array_equal(
        np.concatenate([g.ravel() for g in hooked[0][mode]["grads"]]),
        np.concatenate([g.ravel() for g in hooked[1][mode]["grads"]]))


@pytest.mark.parametrize("mode", ["bucketed", "bucketed_int8"])
def test_hooks_fire_once_and_buckets_launch_in_the_jax_order(hooked, mode):
    cfg, params = _jax_params()
    layout = jov.partition_buckets(
        jax.tree_util.tree_map(jnp.asarray, params), message_size=900)
    for res in hooked:
        r = res[mode]
        assert r["buckets"] == [list(b.leaf_ids) for b in layout.buckets]
        assert r["launch_log"] == list(range(len(layout.buckets)))
        hooks = [i for kind, i in r["events"] if kind == "hook"]
        assert sorted(hooks) == list(range(layout.num_leaves))
        last_hook = max(k for k, (kind, _) in enumerate(r["events"])
                        if kind == "hook")
        assert r["events"].index(("launch", 0)) < last_hook
        # a bucket launches only after all its leaves arrived
        seen = set()
        for kind, i in r["events"]:
            if kind == "hook":
                seen.add(i)
            else:
                assert set(layout.buckets[i].leaf_ids) <= seen


def test_hooked_grads_match_the_jax_mean_gradient(hooked):
    cfg, params = _jax_params()
    toks = _tokens(2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    per_rank = []
    for r in range(2):
        t = jnp.asarray(toks[2 * r:2 * r + 2])
        per_rank.append(jax.grad(lambda p: jax_loss(
            p, {"tokens": t, "targets": t}, cfg))(jp))
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *per_rank)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(mean)]
    got = hooked[0]["bucketed"]["grads"]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(g - r).max() / scale <= 1e-5


# -- the DDP train steps take the hooked form --------------------------------------

def _resnet_steps(rank, world, overlap):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import resnet18_config, resnet_init
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import resnet_train_step
    from apex_tpu_torch.utils.pytree import tree_leaves
    cfg = resnet18_config(width=8, num_classes=10)
    params, bn = resnet_init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    st = amp.initialize(params, FusedAdam(lr=1e-3), opt_level="O2",
                        verbosity=0)
    ddp = DistributedDataParallel(device="cpu", overlap=overlap,
                                  message_size=20_000)
    g = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(2):
        x = torch.randn(4, 16, 16, 3, generator=g)
        y = torch.randint(0, 10, (4,), generator=g)
        st, bn, loss, _ = resnet_train_step(st, bn, x, y, cfg, ddp=ddp)
        losses.append(float(loss))
    eng = ddp.last_reduction
    return (losses, [t.clone() for t in tree_leaves(st.master_params
                                                   or st.model_params)],
            None if eng is None else len(eng.buckets))


def test_resnet_ddp_step_bucketed_gives_the_bits_of_off(tmp_path):
    off = _torch_dist.run_in_process(_resnet_steps, tmp_path, "off")
    on = _torch_dist.run_in_process(_resnet_steps, tmp_path, "bucketed")
    assert off[0] == on[0]
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    assert off[2] is None and on[2] > 1


def _simple_steps(rank, world, env):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.train import simple_ddp_train_step
    if env:
        os.environ[tov.ENV_KNOB] = env
    try:
        g = torch.Generator().manual_seed(0)
        params = {"fc1": {"w": torch.randn(8, 16, generator=g),
                          "b": torch.zeros(16)},
                  "fc2": {"w": torch.randn(16, 4, generator=g),
                          "b": torch.zeros(4)}}
        x = torch.randn(6, 8, generator=g)
        y = torch.randn(6, 4, generator=g)
        st = amp.initialize(params, FusedSGD(lr=0.1, momentum=0.9),
                            opt_level="O1", verbosity=0)
        out = []
        for _ in range(3):
            st, loss = simple_ddp_train_step(st, x, y, device="cpu")
            out.append(float(loss))
        amp.uninit()
        return out, [t.clone() for t in (st.model_params["fc1"]["w"],
                                         st.model_params["fc2"]["w"])]
    finally:
        os.environ.pop(tov.ENV_KNOB, None)


def test_simple_ddp_step_under_the_overlap_knob_gives_the_bits_of_off(
        tmp_path):
    off = _torch_dist.run_in_process(_simple_steps, tmp_path, None)
    on = _torch_dist.run_in_process(_simple_steps, tmp_path, "bucketed")
    assert off[0] == on[0]
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
