"""The port's collective schemes against the JAX package's.

The same numpy inputs from a seed go to the JAX ``parallel.collectives`` /
``allreduce_tree`` / ``overlap`` functions inside ``shard_map`` over 2 or 3
CPU devices and to the port's on spawned gloo ranks (world 2 and 3,
``tests/_torch_dist.py``; world 3 holds Adasum's odd carry); world 1 runs
in this process.  Tolerances, largest magnitude of the reference as the
scale ("peak"):

- the codec (codes, scales, dequantized values): bit-equal;
- fp32 and the plain reduction: bit-equal at world 2, 1e-6 peak at 3;
- int8 sums: 1e-6 peak (each rank's dequantized values are the JAX
  codec's bits; only the order of the fp32 sum may differ); the
  error-feedback residual: bit-equal (it is local);
- bf16: one bf16 step a hop (2^-8 peak a rank), gloo and XLA round the
  bf16 partial sums on their own;
- Adasum: 1e-5 peak (its dot products sum in other orders);
- the spec grammar, the precedence of ``resolve`` (explicit > live
  override > ``APEX_TPU_COLLECTIVES``), ``wire_bytes`` and ``rechunk_flat``:
  equal;
- the meters' logical and wire bytes: equal to the JAX counters;
- the chaos gate: fires through every compressed entry point.
"""
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import allreduce_tree as jax_allreduce_tree
from apex_tpu.parallel import collectives as jc
from apex_tpu.parallel import overlap as jov
from apex_tpu.parallel.mesh import shard_map
from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry.registry import MemorySink as JMemorySink
from apex_tpu.telemetry.registry import Registry as JRegistry

import _torch_dist
from apex_tpu_torch.parallel import collectives as tc

SHAPES = {"a": (3, 100), "b": (4096,), "c": (7, 9)}
BF16_STEP = 2.0 ** -8


def _tree(world, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((world,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(world, seed, per=1024):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((world, world * per)).astype(np.float32)


def _inputs(world):
    return (_tree(world, 1), {k: 0.01 * v for k, v in _tree(world, 2).items()},
            _flat(world, 3), _flat(world, 4, per=256)[:, :256 * 2])


def _peak_close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max() / scale
    assert err <= tol, f"peak error {err:.3g} > {tol:.3g}"


def _jax_map(fn, world, *args, jit=True):
    """``fn`` on each device's row of every (world, ...) argument (trees
    of numpy arrays), inside shard_map; outputs stacked (world, ...).
    ``jit=False`` runs it op by op, as the codec runs called alone: under
    ``jax.jit`` XLA folds the codec's max / 127 into max * (1 / 127), a
    scale one ulp off the codec's own."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    jargs = jax.tree_util.tree_map(jnp.asarray, args)

    @functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                       out_specs=P("data"))
    def run(*a):
        local = jax.tree_util.tree_map(lambda x: x[0], a)
        return jax.tree_util.tree_map(lambda x: x[None], fn(*local))

    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  (jax.jit(run) if jit else run)(*jargs))


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def ranks(request, tmp_path_factory):
    world = request.param
    out = _torch_dist.run_ranks(
        _torch_dist.collective_cases, world,
        tmp_path_factory.mktemp(f"coll{world}"), *_inputs(world))
    return world, out


@pytest.fixture(autouse=True)
def _clean_knobs():
    prev = os.environ.pop(tc.ENV_KNOB, None)
    tc.set_live_spec(None)
    jc.set_live_spec(None)
    yield
    os.environ.pop(tc.ENV_KNOB, None)
    if prev is not None:
        os.environ[tc.ENV_KNOB] = prev
    tc.set_live_spec(None)
    jc.set_live_spec(None)


# -- the codec ----------------------------------------------------------------

@pytest.mark.parametrize("n,block,scale", [
    (1000, 128, 1.0), (4096, 128, 1e-3), (130, 128, 1e5), (777, 64, 3.0),
    (256, 32, 0.0)])
def test_codec_is_the_jax_codec_bit_for_bit(n, block, scale):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[::5] *= 1e-6
    qj, sj = jc.quantize_blockscale(jnp.asarray(x), block)
    qt, st = tc.quantize_blockscale(torch.from_numpy(x), block)
    assert qt.dtype == torch.int8 and tuple(qt.shape) == qj.shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    dj = np.asarray(jc.dequantize_blockscale(qj, sj, n))
    dt = tc.dequantize_blockscale(qt, st, n).numpy()
    np.testing.assert_array_equal(dt.view(np.int32), dj.view(np.int32))


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_adasum_merge_matches_jax(world):
    rng = np.random.default_rng(world)
    st = rng.standard_normal((world, 300)).astype(np.float32)
    st[-1] = st[0] * 0.5                       # a parallel pair
    _peak_close(tc.adasum_merge(torch.from_numpy(st)).numpy(),
                np.asarray(jc.adasum_merge(jnp.asarray(st))), 1e-5)
    z = np.zeros(300, np.float32)
    _peak_close(tc.adasum_pair(torch.from_numpy(st[0]),
                               torch.from_numpy(z)).numpy(), st[0], 0)


# -- the registry, the grammar and the precedence ------------------------------

def test_registry_and_spec_grammar_match_jax():
    assert tc.available() == jc.available()
    for name in tc.available():
        a, b = tc.get_scheme(name), jc.get_scheme(name)
        assert (a.wire_dtype, a.stateful, a.self_scaling) == \
            (b.wire_dtype, b.stateful, b.self_scaling)
        for n in (1, 127, 128, 130, 4096):
            assert tc.wire_bytes(name, n) == jc.wire_bytes(name, n)
            assert tc.wire_bytes(name, n, 64) == jc.wire_bytes(name, n, 64)
    for text in ("int8_blockscale:block=64,min_bytes=99", "adasum",
                 " bf16 ", "fp32:min_bytes=0"):
        assert dataclasses_tuple(tc.parse_spec(text)) == \
            dataclasses_tuple(jc.parse_spec(text))
    for bad in ("no_such_scheme", "fp32:bogus=1", "bf16:block=x"):
        with pytest.raises(tc.CollectiveError):
            tc.parse_spec(bad)
        with pytest.raises(jc.CollectiveError):
            jc.parse_spec(bad)
    assert issubclass(tc.CollectiveError, ValueError)
    spec = tc.CollectiveSpec("int8_blockscale", 128, 4096)
    for nbytes in (0, 4095, 4096):
        assert tc.leaf_scheme(spec, nbytes) == jc.leaf_scheme(
            jc.CollectiveSpec("int8_blockscale", 128, 4096), nbytes)


def dataclasses_tuple(spec):
    return (spec.scheme, spec.block, spec.min_bytes)


@pytest.mark.parametrize("env,live,arg", [
    (None, None, None), ("bf16", None, None), ("off", None, None),
    ("int8_blockscale:min_bytes=0", None, "adasum"),
    ("bf16", "int8_blockscale", None), (None, "adasum:block=64", "fp32"),
    ("none", "bf16", None)])
def test_resolve_precedence_matches_jax(env, live, arg):
    if env is not None:
        os.environ[tc.ENV_KNOB] = env
    tc.set_live_spec(live)
    jc.set_live_spec(live)
    for kw in ({}, {"min_bytes": 7}, {"block": 32}):
        got = tc.resolve(arg, **kw)
        ref = jc.resolve(arg, tuning_key=None, **kw)
        assert (got is None) == (ref is None)
        if got is not None:
            assert dataclasses_tuple(got) == dataclasses_tuple(ref)
    want = None if live is None else tc.parse_spec(live)
    assert tc.get_live_spec() == want
    assert tc.set_live_spec(None) == want and tc.get_live_spec() is None


def test_init_residuals_and_rechunk_match_jax():
    tree = {k: torch.zeros(s) for k, s in SHAPES.items()}
    res = tc.init_residuals(tree)
    assert all(r.dtype == torch.float32 and r.shape == tree[k].shape
               and not r.any() for k, r in res.items())
    buf = np.arange(1, 41, dtype=np.float32)
    buf[30:] = 0
    for total in (30, 48, 128):
        np.testing.assert_array_equal(
            tc.rechunk_flat(buf, used=30, total=total),
            jc.rechunk_flat(buf, used=30, total=total))
    for used, total in ((20, 48), (50, 48)):
        with pytest.raises(ValueError):
            tc.rechunk_flat(buf, used=used, total=total)
        with pytest.raises(ValueError):
            jc.rechunk_flat(buf, used=used, total=total)


# -- world 1 in this process -----------------------------------------------------

def _world1(rank, world, tree_np):
    from apex_tpu_torch.parallel import allreduce_tree
    out = {}
    for s in ("fp32", "bf16", "int8_blockscale", "adasum"):
        local = {k: torch.from_numpy(v[0].copy()) for k, v in tree_np.items()}
        out[s] = {k: v.float().numpy() for k, v in allreduce_tree(
            local, scheme=s, min_compress_bytes=0).items()}
    return out


def test_world1_schemes_are_the_plain_math(tmp_path):
    tree = _tree(1, 9)
    got = _torch_dist.run_in_process(_world1, tmp_path, tree)
    for k, v in tree.items():
        x = v[0]
        np.testing.assert_array_equal(got["fp32"][k], x)
        np.testing.assert_array_equal(got["adasum"][k], x)
        np.testing.assert_array_equal(
            got["bf16"][k], torch.from_numpy(x).bfloat16().float().numpy())
        q, s = tc.quantize_blockscale(torch.from_numpy(x.reshape(-1)))
        np.testing.assert_array_equal(
            got["int8_blockscale"][k],
            tc.dequantize_blockscale(q, s, x.size).reshape(x.shape).numpy())


# -- worlds 2 and 3 against the JAX package ------------------------------------

def _jax_tree_cases(world):
    """The JAX side of every case; the int8 ones op by op (the codec's own
    bits, see :func:`_jax_map`)."""
    tree, res, flat, shard = _inputs(world)
    out = {}
    for s in ("fp32", "bf16", "int8_blockscale", "adasum"):
        out[f"tree_{s}"] = _jax_map(
            lambda t, s=s: jax_allreduce_tree(t, axis_name="data", scheme=s,
                                              min_compress_bytes=0),
            world, tree, jit=s != "int8_blockscale")
    red, new = _jax_map(lambda t, r: jax_allreduce_tree(
        t, axis_name="data", scheme="int8_blockscale", residuals=r),
        world, tree, res, jit=False)
    out["tree_int8_res"], out["tree_int8_res_new"] = red, new
    out["tree_per_leaf"] = _jax_map(lambda t: jax_allreduce_tree(
        t, axis_name="data", predivide_factor=2.0,
        scheme=lambda p, l: "int8_blockscale:min_bytes=0" if "b" in p
        else None), world, tree, jit=False)
    for s in ("fp32", "bf16", "int8_blockscale", "adasum"):
        out[f"rs_{s}"] = _jax_map(lambda x, s=s: jc.reduce_scatter_flat(
            x, "data", jc.resolve(s, tuning_key=None))[0], world, flat,
            jit=s != "int8_blockscale")
    rolled = np.roll(flat, -1, axis=0) * np.float32(0.01)
    out["rs_int8_res"], out["rs_int8_res_new"] = _jax_map(
        lambda x, r: jc.reduce_scatter_flat(
            x, "data", jc.resolve("int8_blockscale", tuning_key=None),
            residual=r), world, flat, rolled, jit=False)
    for s in ("fp32", "bf16", "int8_blockscale"):
        out[f"ag_{s}"] = _jax_map(lambda x, s=s: jc.allgather_flat(
            x, "data", jc.resolve(s, tuning_key=None))[0], world, shard,
            jit=s != "int8_blockscale")
    for name, s in (("none", None), ("fp32", "fp32"),
                    ("int8", "int8_blockscale:min_bytes=0")):
        out[f"bucketed_{name}"] = _jax_map(
            lambda t, s=s: jov.bucketed_allreduce(
                t, axis_name="data", scheme=s, message_size=700),
            world, tree, jit=name != "int8")
    out["bucketed_int8_res"], out["bucketed_int8_res_new"] = _jax_map(
        lambda t, r: jov.bucketed_allreduce(
            t, axis_name="data", scheme="int8_blockscale:min_bytes=0",
            residuals=r, message_size=700), world, tree, res, jit=False)
    # the chunked / segmented forms are the whole-buffer bits in the JAX
    # package (tests/L0/test_overlap.py) as in the port (checked on the
    # port's side), so the int8 ones are held to the whole-buffer JAX
    # collectives, run op by op
    out["chunked_fp32"] = _jax_map(
        lambda x: jov.chunked_reduce_scatter(
            x, "data", jc.resolve("fp32", tuning_key=None),
            residual=jnp.zeros_like(x), message_size=128)[:2], world, flat)
    out["chunked_int8_blockscale"] = _jax_map(
        lambda x: jc.reduce_scatter_flat(
            x, "data", jc.resolve("int8_blockscale", tuning_key=None),
            residual=jnp.zeros_like(x)), world, flat, jit=False)
    out["segmented_fp32"] = _jax_map(
        lambda x: jov.segmented_allgather(
            x, "data", jc.resolve("fp32", tuning_key=None),
            message_size=128)[0], world, shard)
    out["segmented_int8_blockscale"] = out["ag_int8_blockscale"]
    return out


@pytest.fixture(scope="module")
def jax_ref(ranks):
    return _jax_tree_cases(ranks[0])


def _tol(world, scheme):
    return {"fp32": 0.0 if world == 2 else 1e-6,
            "plain": 0.0 if world == 2 else 1e-6,
            "bf16": BF16_STEP * (world - 1),
            "int8": 1e-6, "adasum": 1e-5}[scheme]


TREE_CASES = [("tree_fp32", "fp32"), ("tree_bf16", "bf16"),
              ("tree_int8_blockscale", "int8"), ("tree_adasum", "adasum"),
              ("tree_int8_res", "int8"), ("tree_per_leaf", "int8"),
              ("bucketed_none", "plain"), ("bucketed_fp32", "fp32"),
              ("bucketed_int8", "int8"), ("bucketed_int8_res", "int8")]


@pytest.mark.parametrize("case,kind", TREE_CASES,
                         ids=[c for c, _ in TREE_CASES])
def test_tree_reductions_match_jax(ranks, jax_ref, case, kind):
    world, out = ranks
    for rank in range(world):
        for k in SHAPES:
            _peak_close(out[rank][case][k], jax_ref[case][k][rank],
                        _tol(world, kind))


@pytest.mark.parametrize("case", ["tree_int8_res_new",
                                  "bucketed_int8_res_new"])
def test_error_feedback_residuals_match_jax(ranks, jax_ref, case):
    world, out = ranks
    for rank in range(world):
        for k in SHAPES:
            np.testing.assert_array_equal(out[rank][case][k],
                                          jax_ref[case][k][rank])


FLAT_CASES = [("rs_fp32", "fp32"), ("rs_bf16", "bf16"),
              ("rs_int8_blockscale", "int8"), ("rs_adasum", "adasum"),
              ("rs_int8_res", "int8"), ("ag_fp32", "fp32"),
              ("ag_bf16", "fp32"), ("ag_int8_blockscale", "fp32")]


@pytest.mark.parametrize("case,kind", FLAT_CASES,
                         ids=[c for c, _ in FLAT_CASES])
def test_flat_collectives_match_jax(ranks, jax_ref, case, kind):
    """The all-gathers move data only (bit-equal at any world); the
    reduce-scatters sum."""
    world, out = ranks
    tol = 0.0 if case.startswith("ag_") else _tol(world, kind)
    for rank in range(world):
        _peak_close(out[rank][case], jax_ref[case][rank], tol)
    if case == "rs_int8_res":
        for rank in range(world):
            np.testing.assert_array_equal(out[rank]["rs_int8_res_new"],
                                          jax_ref["rs_int8_res_new"][rank])


def test_allgather_wire_accounting_matches_jax(ranks):
    world, out = ranks
    n = _inputs(world)[3].shape[1]
    assert out[0]["ag_fp32_wire"] == (4 * n, "float32")
    assert out[0]["ag_bf16_wire"] == (2 * n, "bfloat16")
    assert out[0]["ag_int8_blockscale_wire"] == (
        jc.wire_bytes("int8_blockscale", n), "int8")


@pytest.mark.parametrize("scheme", ["fp32", "int8_blockscale"])
def test_chunked_forms_are_the_whole_buffer_bits_and_jax(ranks, jax_ref,
                                                         scheme):
    world, out = ranks
    for rank in range(world):
        g, r, n, same_g, same_r = out[rank][f"chunked_{scheme}"]
        assert n > 1 and same_g and same_r
        jg, jr = jax_ref[f"chunked_{scheme}"]
        _peak_close(g, jg[rank], _tol(world, "fp32" if scheme == "fp32"
                                      else "int8"))
        np.testing.assert_array_equal(r, jr[rank])
        full, wire, dt, n, same = out[rank][f"segmented_{scheme}"]
        assert n > 1 and same
        np.testing.assert_array_equal(full, jax_ref[f"segmented_{scheme}"][
            rank])


def test_meters_match_jax_counters(ranks):
    """The logical and wire bytes of one int8 ``allreduce_tree`` (the
    small leaf under min_bytes stays fp32) and one bucketed reduction."""
    world, out = ranks
    tree = _inputs(world)[0]
    reg = JRegistry(sink=JMemorySink(), flush_interval=0, rank0_only=False)
    jevents.set_default(reg)
    try:
        _jax_map(lambda t: jax_allreduce_tree(
            t, axis_name="data", scheme="int8_blockscale:min_bytes=1024"),
            world, tree)
        _jax_map(lambda t: jov.bucketed_allreduce(
            t, axis_name="data", message_size=700), world, tree)
        ref = reg.read()
    finally:
        jevents.set_default(None)
    for rank in range(world):
        got = out[rank]["meters"]
        for key in ("ddp.allreduce_bytes", "ddp.allreduce_compressed_bytes",
                    "ddp.allreduce_calls", "ddp.allreduce_leaves"):
            assert got[key] == ref[key], key
    logical = sum(int(np.prod(s)) for s in SHAPES.values()) * 4
    assert got["ddp.allreduce_bytes"] == 2 * logical


def test_chaos_gate_fires_through_every_compressed_entry(ranks):
    world, out = ranks
    for rank in range(world):
        fired = out[rank]["chaos"]
        assert fired == {"tree_fp32": True, "tree_bf16": True,
                         "tree_int8_blockscale": True, "tree_adasum": True,
                         "rs_bf16": True, "rs_int8_blockscale": True,
                         "rs_adasum": True, "ag_int8_blockscale": True}


#: JAX public names the port leaves out, with the reason (none: the
#: tuning profile's keys ``TUNING_KEY`` / ``AG_TUNING_KEY`` exist and are
#: read on the card, ``tests/test_torch_tuning_knobs.py``)
NO_COUNTERPART = {}


@pytest.mark.parametrize("module", ["collectives", "overlap",
                                    "weight_update"])
def test_every_jax_public_name_has_a_counterpart(module):
    """Each public name of the JAX module (its ``__all__``, else every name
    it defines and does not import) exists in the port's module of the same
    name, apart from those :data:`NO_COUNTERPART` lists, which the port
    must not carry."""
    import importlib
    import inspect
    jm = importlib.import_module(f"apex_tpu.parallel.{module}")
    tm = importlib.import_module(f"apex_tpu_torch.parallel.{module}")
    names = getattr(jm, "__all__", None) or [
        n for n, v in vars(jm).items() if not n.startswith("_")
        and not inspect.ismodule(v)
        and getattr(v, "__module__", jm.__name__) == jm.__name__]
    assert names
    skip = NO_COUNTERPART.get(module, set())
    assert skip <= set(names)
    missing = [n for n in names if n not in skip and not hasattr(tm, n)]
    assert not missing, missing
    assert not any(hasattr(tm, n) for n in skip)
