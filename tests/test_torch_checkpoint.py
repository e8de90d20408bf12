"""Checkpoints of the PyTorch port against the JAX package's.

The JAX package's ``tests/L0/test_resilience.py`` checkpoint cases run
against ``apex_tpu_torch.checkpoint``: the CRC-framed round trip, a leaf
past the ~64 KB pickle framing threshold, truncated, corrupted, garbage,
empty and legacy bare-pickle files.  ``restore_like`` keeps each
template leaf's shape (or raises ``ValueError``), dtype, device and
strides.

Across the packages, in both directions: a file either one writes
verifies, loads and restores in the other with bit-equal leaves for fp32,
fp16 and bf16 trees, for the three optimizer states (``FusedAdamState``,
``FusedLAMBState``, ``FusedSGDState``, which the port writes under the
JAX names and reads into its own classes), for a leaf over 64 KB and for
a legacy bare pickle.  In a subprocess with neither JAX nor ``ml_dtypes``
importable, the port saves and loads a bf16 checkpoint and imports
neither.  ``save_sharded`` / ``load_sharded`` (``torch.distributed.
checkpoint``; no format shared with the JAX package) round-trip in one
process and on two gloo ranks.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import checkpoint as jckpt
from apex_tpu.optimizers.fused_adam import FusedAdamState as JAdamState
from apex_tpu.optimizers.fused_lamb import FusedLAMBState as JLAMBState
from apex_tpu.optimizers.fused_sgd import FusedSGDState as JSGDState

from apex_tpu_torch import _pickle_compat, checkpoint
from apex_tpu_torch.checkpoint import CheckpointError
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMBState
from apex_tpu_torch.optimizers.fused_sgd import FusedSGDState
from apex_tpu_torch.utils.pytree import tree_leaves

from _torch_dist import run_in_process, run_ranks, sharded_ckpt_roundtrip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDT = {"float32": torch.float32, "float16": torch.float16,
       "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "float16": jnp.float16,
       "bfloat16": jnp.bfloat16}


def _bits(x):
    """(shape, dtype name, raw bytes) of a tensor, a JAX array or a numpy
    array (an ``ml_dtypes`` or ``_pickle_compat.BF16`` one included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        name = str(x.dtype).replace("torch.", "")
        a = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    else:
        a = np.asarray(x)
        name = "bfloat16" if _pickle_compat.is_bf16(a) else a.dtype.name
    return tuple(a.shape), name, np.ascontiguousarray(a).tobytes()


def _leaf_values(seed, dtype, shapes=((3, 5), (7,), (2, 2, 4))):
    """fp32 numpy values, cast to ``dtype`` by each package."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_tree(vals, dtype):
    return {f"w{i}": jnp.asarray(v).astype(JDT[dtype])
            for i, v in enumerate(vals)}


def _torch_tree(vals, dtype):
    return {f"w{i}": torch.from_numpy(v).to(TDT[dtype])
            for i, v in enumerate(vals)}


# ---------------------------------------------------------------------------
# tests/L0/test_resilience.py:157-220, against the port
# ---------------------------------------------------------------------------

def _write_ckpt(path):
    checkpoint.save(str(path), step=3, w=torch.arange(4, dtype=torch.float32))
    return str(path)


def test_checkpoint_roundtrip_crc_framed(tmp_path):
    p = _write_ckpt(tmp_path / "a.ckpt")
    got = checkpoint.load(p)
    assert got["step"] == 3
    np.testing.assert_array_equal(got["w"], np.arange(4, dtype=np.float32))
    checkpoint.verify(p)
    with open(p, "rb") as f:
        assert f.read(len(checkpoint._MAGIC)) == b"APEXCKPT1\x00"
        length, _ = checkpoint._HEADER.unpack(f.read(12))
    assert length == os.path.getsize(p) - len(checkpoint._MAGIC) - 12


def test_checkpoint_large_leaf_roundtrip(tmp_path):
    big = torch.from_numpy(
        np.random.RandomState(0).randn(64 * 1024).astype(np.float32))
    p = str(tmp_path / "big.ckpt")
    checkpoint.save(p, step=1, w=big)
    checkpoint.verify(p)
    np.testing.assert_array_equal(checkpoint.load(p)["w"], big.numpy())


def test_checkpoint_load_truncated_raises_checkpoint_error(tmp_path):
    p = _write_ckpt(tmp_path / "t.ckpt")
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(CheckpointError, match="truncated"):
        checkpoint.load(p)
    with pytest.raises(CheckpointError):
        checkpoint.verify(p)
    open(p, "wb").write(blob[:len(checkpoint._MAGIC) + 5])
    with pytest.raises(CheckpointError, match="truncated checkpoint header"):
        checkpoint.verify(p)


def test_checkpoint_load_checksum_mismatch_raises(tmp_path):
    p = _write_ckpt(tmp_path / "c.ckpt")
    blob = bytearray(open(p, "rb").read())
    blob[-1] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        checkpoint.load(p)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        checkpoint.verify(p)


def test_checkpoint_load_garbage_raises_not_unpickling_error(tmp_path):
    p = tmp_path / "g.ckpt"
    p.write_bytes(b"this is not a checkpoint at all")
    with pytest.raises(CheckpointError):
        checkpoint.load(str(p))
    (tmp_path / "e.ckpt").write_bytes(b"")
    with pytest.raises(CheckpointError, match="empty"):
        checkpoint.load(str(tmp_path / "e.ckpt"))


def test_checkpoint_legacy_bare_pickle_still_loads(tmp_path):
    p = tmp_path / "legacy.ckpt"
    with open(p, "wb") as f:
        pickle.dump({"step": 9, "w": np.ones(2)}, f)
    got = checkpoint.load(str(p))
    assert got["step"] == 9
    checkpoint.verify(str(p))


def test_save_is_atomic_and_leaves_no_temp_file(tmp_path):
    p = str(tmp_path / "x.ckpt")
    checkpoint.save(p, step=1, w=torch.ones(3))

    class Boom:
        def __reduce__(self):
            raise RuntimeError("unpicklable")
    with pytest.raises(RuntimeError, match="unpicklable"):
        checkpoint.save(p, step=2, w=Boom())
    assert checkpoint.load(p)["step"] == 1         # the old file stands
    assert os.listdir(tmp_path) == ["x.ckpt"]


# ---------------------------------------------------------------------------
# restore_like
# ---------------------------------------------------------------------------

def test_restore_like_casts_places_and_keeps_strides(tmp_path):
    conv = torch.randn(8, 3, 5, 5).contiguous(
        memory_format=torch.channels_last)
    tmpl = {"conv": conv, "b": torch.zeros(4, dtype=torch.float16),
            "n": torch.zeros((), dtype=torch.int32)}
    p = str(tmp_path / "r.ckpt")
    checkpoint.save(p, t={"conv": conv * 2, "b": torch.arange(4.0),
                          "n": torch.tensor(7, dtype=torch.int32)})
    got = checkpoint.restore_like(tmpl, checkpoint.load(p)["t"])
    assert got["conv"].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got["conv"], conv * 2)
    assert got["b"].dtype == torch.float16 and got["b"].tolist() == \
        [0.0, 1.0, 2.0, 3.0]
    assert got["n"].dtype == torch.int32 and int(got["n"]) == 7
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_like({"b": torch.zeros(5)},
                                {"b": np.zeros(4, np.float32)})


def test_restore_like_bf16_is_a_bit_view():
    """bf16 leaves become tensors by a bit view, not through fp32: a NaN
    payload and the smallest subnormal keep their bits."""
    bits = np.array([0x7FC1, 0x0001, 0x8000, 0x3F80], np.uint16)
    host = _pickle_compat.bf16_to_numpy(bits)
    got = checkpoint.restore_like(torch.zeros(4, dtype=torch.bfloat16), host)
    assert got.view(torch.int16).numpy().view(np.uint16).tolist() == \
        bits.tolist()


# ---------------------------------------------------------------------------
# across the packages, both directions, bit-equal leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_jax_written_file_restores_in_port(dtype, tmp_path):
    vals = _leaf_values(1, dtype)
    jt = _jax_tree(vals, dtype)
    p = str(tmp_path / "j.ckpt")
    jckpt.save(p, step=4, tree=jt, meta={"lr": 0.1, "name": "x"})
    checkpoint.verify(p)
    got = checkpoint.load(p)
    assert got["step"] == 4 and got["meta"] == {"lr": 0.1, "name": "x"}
    tmpl = {k: torch.zeros(v.shape, dtype=TDT[dtype]) for k, v in jt.items()}
    restored = checkpoint.restore_like(tmpl, got["tree"])
    for k in jt:
        assert restored[k].dtype == TDT[dtype]
        assert _bits(restored[k]) == _bits(jt[k]), k


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_port_written_file_restores_in_jax(dtype, tmp_path):
    vals = _leaf_values(2, dtype)
    tt = _torch_tree(vals, dtype)
    p = str(tmp_path / "t.ckpt")
    checkpoint.save(p, step=5, tree=tt, meta={"lr": 0.1})
    jckpt.verify(p)
    got = jckpt.load(p)
    assert got["step"] == 5 and got["meta"] == {"lr": 0.1}
    assert got["tree"]["w0"].dtype == jnp.dtype(JDT[dtype])
    tmpl = {k: jnp.zeros(v.shape, JDT[dtype]) for k, v in tt.items()}
    restored = jckpt.restore_like(tmpl, got["tree"])
    for k in tt:
        assert _bits(restored[k]) == _bits(tt[k]), k


def _jax_states(seed):
    """The JAX package's three optimizer states, xla (tree) and fused
    (flat, with master) forms, from seeded numpy."""
    rng = np.random.default_rng(seed)

    def t():
        return {"a": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
                "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}

    def flat(n=17):
        return jnp.asarray(rng.standard_normal(n), jnp.float32)
    return {
        "adam": JAdamState(jnp.int32(3), t(), t()),
        "adam_fused": JAdamState(jnp.int32(2), flat(), flat(), flat()),
        "lamb": JLAMBState(jnp.int32(5), t(), t()),
        "lamb_fused": JLAMBState(jnp.int32(1), flat(), flat(), flat()),
        "sgd": JSGDState(jnp.int32(7), t()),
        "sgd_fused": JSGDState(jnp.int32(4), flat(), flat()),
    }


PORT_STATE = {"adam": FusedAdamState, "lamb": FusedLAMBState,
              "sgd": FusedSGDState}


def _to_port(state):
    cls = PORT_STATE[{JAdamState: "adam", JLAMBState: "lamb",
                      JSGDState: "sgd"}[type(state)]]

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x))
    return cls(*[conv(f) for f in state])


@pytest.mark.parametrize("kind", sorted(_jax_states(0)))
def test_opt_states_cross_both_ways(kind, tmp_path):
    jst = _jax_states(3)[kind]
    pst = _to_port(jst)
    # JAX -> port: the port's class, restorable into a port template
    pj = str(tmp_path / "j.ckpt")
    jckpt.save(pj, opt=jst)
    got = checkpoint.load(pj)["opt"]
    assert type(got) is type(pst)
    tmpl = _to_port(jax.tree_util.tree_map(jnp.zeros_like, jst))
    restored = checkpoint.restore_like(tmpl, got)
    assert type(restored) is type(pst)
    for a, b in zip(tree_leaves(restored), jax.tree_util.tree_leaves(jst)):
        assert _bits(a) == _bits(b)
    # port -> JAX: the JAX class, restorable into a JAX template
    pt = str(tmp_path / "t.ckpt")
    checkpoint.save(pt, opt=pst)
    jgot = jckpt.load(pt)["opt"]
    assert type(jgot) is type(jst)
    jres = jckpt.restore_like(jax.tree_util.tree_map(jnp.zeros_like, jst),
                              jgot)
    assert type(jres) is type(jst)
    for a, b in zip(jax.tree_util.tree_leaves(jres), tree_leaves(pst)):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_over_64kb_crosses(direction, dtype, tmp_path):
    v = np.random.RandomState(5).randn(40_000).astype(np.float32)
    j, t = jnp.asarray(v).astype(JDT[dtype]), torch.from_numpy(v).to(
        TDT[dtype])
    assert _bits(j) == _bits(t) and len(_bits(t)[2]) > 64 * 1024
    p = str(tmp_path / "big.ckpt")
    if direction == "jax_to_port":
        jckpt.save(p, w=j)
        checkpoint.verify(p)
        got = checkpoint.restore_like(torch.zeros_like(t),
                                      checkpoint.load(p)["w"])
    else:
        checkpoint.save(p, w=t)
        jckpt.verify(p)
        got = jckpt.restore_like(jnp.zeros_like(j), jckpt.load(p)["w"])
    assert _bits(got) == _bits(t)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_legacy_bare_pickle_crosses(direction, tmp_path):
    """A bare pickle (no header) written the way each package pickles
    its payload loads in the other, bf16 and state classes included."""
    v = _leaf_values(6, "bfloat16")[0]
    p = tmp_path / "legacy.ckpt"
    if direction == "jax_to_port":
        payload = {"step": 2, "w": np.asarray(jnp.asarray(v, jnp.bfloat16)),
                   "opt": JSGDState(np.int32(1), {"a": v})}
        with open(p, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        checkpoint.verify(str(p))
        got = checkpoint.load(str(p))
        assert type(got["opt"]) is FusedSGDState
        w = checkpoint.restore_like(torch.zeros(v.shape, dtype=torch.bfloat16),
                                    got["w"])
        assert _bits(w) == _bits(payload["w"])
    else:
        t = torch.from_numpy(v).bfloat16()
        with open(p, "wb") as f:
            _pickle_compat.Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(
                {"step": 2, "w": checkpoint._to_host(t),
                 "opt": FusedSGDState(np.int32(1), {"a": v})})
        jckpt.verify(str(p))
        got = jckpt.load(str(p))
        assert type(got["opt"]) is JSGDState
        assert _bits(got["w"]) == _bits(t)


def test_unknown_jax_names_are_refused_without_import(tmp_path):
    """A JAX name outside the table (the scaler's dataclass here) is a
    ``CheckpointError`` naming it; so is an ``ml_dtypes`` type other than
    bfloat16."""
    from apex_tpu.amp import scaler as jscaler
    p = str(tmp_path / "s.ckpt")
    jckpt.save(p, scaler=jscaler.init())
    with pytest.raises(CheckpointError, match="apex_tpu.amp.scaler"):
        checkpoint.load(p)
    import ml_dtypes
    jckpt.save(p, w=np.zeros(2, ml_dtypes.float8_e4m3fn))
    with pytest.raises(CheckpointError, match="float8_e4m3fn"):
        checkpoint.load(p)


def test_port_runs_bf16_checkpoints_without_ml_dtypes_or_jax(tmp_path):
    """In a fresh interpreter that cannot import ``ml_dtypes``, ``jax`` or
    ``apex_tpu`` (a GPU host need have none of them), the port saves a
    bf16 tree and an optimizer state, verifies, loads and restores them
    bit for bit, and reads a JAX-written bf16 file from this test."""
    j = jnp.asarray(_leaf_values(8, "bfloat16")[0], jnp.bfloat16)
    jfile = str(tmp_path / "jax.ckpt")
    jckpt.save(jfile, w=j, opt=JAdamState(jnp.int32(1), {"a": j}, {"a": j}))
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("ml_dtypes", "jax", "apex_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        from apex_tpu_torch import checkpoint
        from apex_tpu_torch.optimizers.fused_adam import FusedAdamState
        w = torch.linspace(-3, 3, 11).bfloat16()
        st = FusedAdamState(torch.tensor(2, dtype=torch.int32), {{"a": w}},
                            {{"a": w}})
        p = {str(tmp_path / "port.ckpt")!r}
        checkpoint.save(p, w=w, opt=st)
        checkpoint.verify(p)
        got = checkpoint.load(p)
        r = checkpoint.restore_like({{"w": w, "opt": st}}, got)
        assert r["w"].dtype == torch.bfloat16 and torch.equal(r["w"], w)
        assert type(r["opt"]) is FusedAdamState
        assert torch.equal(r["opt"].m["a"], w)
        jg = checkpoint.load({jfile!r})
        jw = checkpoint.restore_like(torch.zeros(3, 5, dtype=torch.bfloat16),
                                     jg["w"])
        assert type(jg["opt"]) is FusedAdamState
        print(jw.view(torch.int16).tolist())
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("ml_dtypes", "jax", "apex_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split()
    assert lines[-1] == "ok"
    want = np.asarray(j).view(np.int16).tolist()
    assert eval(out.stdout.splitlines()[-2]) == want


# ---------------------------------------------------------------------------
# save_sharded / load_sharded (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 6, generator=g),
            "h": torch.randn(3, generator=g).half(),
            "opt": FusedAdamState(torch.tensor(3, dtype=torch.int32),
                                  {"w": torch.randn(4, 6, generator=g)},
                                  {"w": torch.randn(4, 6, generator=g)})}


def test_save_sharded_roundtrip_and_overwrite(tmp_path):
    path = str(tmp_path / "sharded")
    a, b = _tree(0), _tree(1)
    checkpoint.save_sharded(path, a)
    zeros = tree_leaves(_tree(2))
    got = checkpoint.load_sharded(path, _tree(2))
    assert type(got["opt"]) is FusedAdamState
    for x, y, z in zip(tree_leaves(got), tree_leaves(a), zeros):
        assert x.dtype == z.dtype and torch.equal(x, y)
    checkpoint.save_sharded(path, b)               # overwrite: swap in
    assert not os.path.exists(path + ".new")
    assert not os.path.exists(path + ".old")
    for x, y in zip(tree_leaves(checkpoint.load_sharded(path, _tree(2))),
                    tree_leaves(b)):
        assert torch.equal(x, y)
    # a save cut between its two renames leaves the last checkpoint at
    # .old: load reads it, the next save puts it back first
    os.rename(path, path + ".old")
    for x, y in zip(tree_leaves(checkpoint.load_sharded(path, _tree(2))),
                    tree_leaves(b)):
        assert torch.equal(x, y)
    checkpoint.save_sharded(path, a)
    assert os.path.exists(path) and not os.path.exists(path + ".old")


def test_save_sharded_world_1_group(tmp_path):
    res = run_in_process(sharded_ckpt_roundtrip, tmp_path,
                         str(tmp_path / "w1"))
    assert res == [True, True]


def test_save_sharded_two_gloo_ranks(tmp_path):
    res = run_ranks(sharded_ckpt_roundtrip, 2, tmp_path,
                    str(tmp_path / "w2"))
    assert res == [[True, True], [True, True]]
