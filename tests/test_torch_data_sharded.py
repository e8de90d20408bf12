"""The port's shard-addressed data plane against the JAX package's.

The JAX package's ``tests/L0/test_data_sharded.py`` cases run against
``apex_tpu_torch.data`` (all but its native-loader and guard cases, and
without the telemetry records, which the port has no registry for): the
index round trip, the digest surviving a lost index and the
``index_missing`` fault, lazy and eager checksums naming shard and
offset, exact per-epoch permutations, the world-invariant host slices,
seek-to-step equal to sequential iteration, the ``shard_corrupt`` fault,
bounded stall retries.  Across the packages, on one directory: the same
``INDEX.json`` (bytes and digest), the same record ids per (seed, step,
world, host), the same batch bytes, cursors and ``data_meta`` from the
two ``ShardedLoader``\\ s, sequential and seeked.
"""
import json
import os
import time
import warnings

import numpy as np
import pytest

from apex_tpu.data import sharded as jsharded
from apex_tpu.resilience import faults as jfaults

from apex_tpu_torch import data
from apex_tpu_torch.data import (DatasetError, IndexMissingWarning,
                                 LoaderStallError, ShardChecksumError,
                                 ShardedDataset, ShardedLoader, build_index,
                                 global_records, host_records, load_index,
                                 locate_step, open_dataset)
from apex_tpu_torch.data import sharded as sharded_mod
from apex_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _no_installed_plan():
    prev, jprev = faults.install(None), jfaults.install(None)
    yield
    faults.install(prev)
    jfaults.install(jprev)


def _write_shards(d, sizes, *, width=4, images=False, seed=0):
    """Self-identifying shards (record r's row encodes r); with
    ``images``, seeded uint8 NHWC ``images`` and int ``labels`` too."""
    n = 0
    rng = np.random.default_rng(seed)
    for i, sz in enumerate(sizes):
        arrs = {"x": (np.arange(n, n + sz, dtype=np.float32)[:, None]
                      * np.ones((1, width), np.float32)),
                "y": np.arange(n, n + sz, dtype=np.int32)}
        if images:
            arrs = {"images": rng.integers(0, 256, (sz, 8, 8, 3),
                                           dtype=np.uint8),
                    "labels": rng.integers(0, 10, sz).astype(np.int64)}
        np.savez(os.path.join(d, f"shard-{i:03d}.npz"), **arrs)
        n += sz
    return n


# ---------------------------------------------------------------------------
# index + checksums
# ---------------------------------------------------------------------------

def test_index_build_load_roundtrip(tmp_path):
    d = str(tmp_path)
    n = _write_shards(d, [7, 5, 9])
    idx = build_index(d)
    assert idx.n_records == n == 21
    assert [s.n for s in idx.shards] == [7, 5, 9]
    assert idx.keys == ("x", "y")
    assert load_index(d) == idx
    doc = json.loads((tmp_path / "INDEX.json").read_text())
    assert doc["digest"] == idx.digest and doc["n_records"] == 21
    assert [idx.locate(r) for r in (0, 6, 7, 12, 20)] == \
        [(0, 0), (0, 6), (1, 0), (2, 0), (2, 8)]
    with pytest.raises(DatasetError, match="outside dataset"):
        idx.locate(21)


def test_index_missing_degrades_to_scan_with_same_digest(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [4, 4])
    idx = build_index(d)
    os.unlink(tmp_path / "INDEX.json")
    with pytest.warns(IndexMissingWarning, match="directory scan"):
        idx2 = load_index(d)
    assert idx2.digest == idx.digest and idx2.shards == idx.shards
    ds = open_dataset(d)
    assert os.path.exists(tmp_path / "INDEX.json")
    assert ds.index.digest == idx.digest


def test_index_missing_fault_kind(tmp_path):
    assert "index_missing" in faults.KINDS
    d = str(tmp_path)
    _write_shards(d, [4, 4])
    idx = build_index(d)
    base = sharded_mod._OPEN_CALLS["n"]
    faults.install(faults.parse(f"index_missing@{base}"))
    with pytest.warns(IndexMissingWarning):
        idx2 = load_index(d)
    assert idx2.digest == idx.digest
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_index(d).digest == idx.digest


def test_bad_shard_sets_raise(tmp_path):
    with pytest.raises(DatasetError, match="no .npz shards"):
        build_index(str(tmp_path))
    np.savez(tmp_path / "a.npz", x=np.zeros(3), y=np.zeros(4))
    with pytest.raises(DatasetError, match="disagree on the record dim"):
        build_index(str(tmp_path))
    os.unlink(tmp_path / "a.npz")
    np.savez(tmp_path / "a.npz", x=np.zeros(3))
    np.savez(tmp_path / "b.npz", z=np.zeros(3))
    with pytest.raises(DatasetError, match="must agree on their array"):
        build_index(str(tmp_path))


def test_lazy_checksum_raises_typed_error_naming_shard_and_offset(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [6, 6])
    ds = ShardedDataset(d, index=build_index(d))
    p = tmp_path / "shard-001.npz"
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    p.write_bytes(bytes(raw))
    with pytest.raises(ShardChecksumError,
                       match=r"shard-001\.npz.*record offset 3") as ei:
        ds.gather(np.asarray([9]))
    assert ei.value.shard == "shard-001.npz" and ei.value.offset == 3
    with pytest.raises(ShardChecksumError, match="shard-001"):
        ds.verify()
    np.testing.assert_array_equal(ds.gather(np.asarray([2, 5]))["y"], [2, 5])


def test_verify_sweep_passes_clean_dataset(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [5, 5, 5])
    assert ShardedDataset(d, index=build_index(d)).verify() == 3


def test_shard_cache_is_bounded_lru(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [3, 3, 3, 3])
    ds = ShardedDataset(d, index=build_index(d), cache_shards=2)
    ds.gather(np.asarray([0, 3, 6, 9]))
    assert list(ds._cache) == [2, 3]
    ds.gather(np.asarray([7]))
    assert list(ds._cache) == [3, 2]


# ---------------------------------------------------------------------------
# pure addressing
# ---------------------------------------------------------------------------

def test_epoch_is_exact_permutation_and_reshuffles(tmp_path):
    d = str(tmp_path)
    n = _write_shards(d, [13, 14, 13])
    gb = 8
    e0 = np.concatenate([global_records(3, s, n, gb) for s in range(5)])
    e1 = np.concatenate([global_records(3, s, n, gb) for s in range(5, 10)])
    assert len(set(e0.tolist())) == len(e0) == 40
    assert sorted(e0.tolist()) == sorted(e1.tolist()) == list(range(40))
    assert not np.array_equal(e0, e1)
    assert len(global_records(3, 0, 43, gb)) == gb


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_host_slices_reassemble_global_batch_bitwise(world):
    n, gb = 37 * 3, 8
    for step in (0, 3, 7, 26):
        cat = np.concatenate([host_records(5, step, n, gb, world, h)
                              for h in range(world)])
        np.testing.assert_array_equal(cat, global_records(5, step, n, gb))


def test_reassignment_n_to_m_no_drop_no_dup():
    n, gb = 120 - 7, 24
    for (a, b) in [(8, 4), (4, 8), (6, 2), (2, 6), (24, 3)]:
        for step in (0, 2, 4):
            ra = np.concatenate([host_records(9, step, n, gb, a, h)
                                 for h in range(a)])
            rb = np.concatenate([host_records(9, step, n, gb, b, h)
                                 for h in range(b)])
            np.testing.assert_array_equal(ra, rb)


def test_locate_step_addresses_shard_offsets(tmp_path):
    d = str(tmp_path)
    n = _write_shards(d, [7, 5, 9])
    idx = build_index(d)
    ds = ShardedDataset(d, index=idx)
    for world, host in [(1, 0), (3, 1)]:
        addr = locate_step(idx, 2, 1, 6, world, host)
        ids = host_records(2, 1, n, 6, world, host)
        got = ds.gather(ids)
        for (si, off), rid, y in zip(addr, ids, got["y"]):
            assert 0 <= si < 3 and 0 <= off < idx.shards[si].n
            assert int(y) == int(rid)


def test_addressing_validation(tmp_path):
    with pytest.raises(DatasetError, match="not even one full batch"):
        global_records(0, 0, 4, 8)
    with pytest.raises(DatasetError, match="divide over world"):
        host_records(0, 0, 64, 8, world=3)
    with pytest.raises(DatasetError, match="host/world"):
        host_records(0, 0, 64, 8, world=2, host=2)
    with pytest.raises(DatasetError, match="global_batch must be"):
        global_records(0, 0, 64, 0)
    d = str(tmp_path)
    _write_shards(d, [8, 8])
    ds = ShardedDataset(d, index=build_index(d))
    with pytest.raises(DatasetError, match="not both"):
        ShardedLoader(ds, global_batch=4, num_steps=2, epochs=1)
    assert ShardedLoader(ds, global_batch=4, epochs=2).num_steps == 8
    with pytest.raises(DatasetError, match="needs num_steps"):
        next(iter(ShardedLoader(ds, global_batch=4)))


# ---------------------------------------------------------------------------
# seek-to-step == sequential iteration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,resume_step", [(1, 0), (1, 7), (2, 3),
                                               (4, 9), (8, 5)])
def test_seek_to_step_bitwise_vs_sequential(world, resume_step, tmp_path):
    d = str(tmp_path)
    _write_shards(d, [11, 9, 12, 8])
    idx = build_index(d)
    for host in range(world):
        ld = ShardedLoader(ShardedDataset(d, index=idx), global_batch=8,
                           seed=4, world=world, host=host, num_steps=12)
        seq = list(iter(ld))
        assert len(seq) == 12
        for s in range(resume_step, 12):
            b = ld(s)
            np.testing.assert_array_equal(b["x"], seq[s]["x"])
            np.testing.assert_array_equal(b["y"], seq[s]["y"])
            assert b["x"].dtype == seq[s]["x"].dtype
        ld.seek(resume_step)
        for s, b in zip(range(resume_step, 12), iter(ld)):
            np.testing.assert_array_equal(b["y"], seq[s]["y"])


def test_cursor_and_data_meta(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [7, 9])
    ld = ShardedLoader(open_dataset(d), global_batch=4, seed=1,
                       num_steps=9)
    meta = ld.data_meta()
    assert meta == {"kind": "sharded", "index_digest": ld.index_digest,
                    "n_records": 16, "global_batch": 4, "seed": 1,
                    "world": 1, "steps_per_epoch": 4}
    cur = ld.cursor(5)
    assert (cur["step"], cur["epoch"], cur["epoch_step"]) == (5, 1, 1)
    first = int(ld._records(5)[0])
    si, off = ld.dataset.index.locate(first)
    assert cur["shard"] == f"shard-{si:03d}.npz" and \
        cur["shard_offset"] == off


# ---------------------------------------------------------------------------
# shard_corrupt fault kind, stall retries
# ---------------------------------------------------------------------------

def test_shard_corrupt_fault_typed_error_one_shot(tmp_path):
    assert "shard_corrupt" in faults.KINDS
    d = str(tmp_path)
    _write_shards(d, [10, 10])
    ld = ShardedLoader(ShardedDataset(d, index=build_index(d)),
                       global_batch=4, seed=0, num_steps=5,
                       plan=faults.parse("shard_corrupt@2"))
    clean = [ld(s) for s in (0, 1)]
    with pytest.raises(ShardChecksumError, match="record offset") as ei:
        ld(2)
    assert ei.value.shard.startswith("shard-")
    b2 = ld(2)
    assert np.isfinite(b2["x"]).all()
    np.testing.assert_array_equal(ld(0)["x"], clean[0]["x"])
    # the file on disk was never touched
    assert ShardedDataset(d).verify() == 2


def test_shard_corrupt_surfaces_through_prefetch_iteration(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [10, 10])
    ld = ShardedLoader(ShardedDataset(d, index=build_index(d)),
                       global_batch=4, seed=0, num_steps=5,
                       plan=faults.parse("shard_corrupt@1"))
    it = iter(ld)
    next(it)
    with pytest.raises(ShardChecksumError):
        next(it)


def test_fault_grammar_rows():
    p = faults.parse("shard_corrupt@3:17;index_missing@0")
    assert [s.kind for s in p.specs] == ["shard_corrupt", "index_missing"]
    assert p.specs[0].arg == 17.0


def test_loader_stall_fault_trips_wait_timeout(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [8, 8])
    faults.install(faults.parse("loader_stall@1:0.3"))
    ld = ShardedLoader(ShardedDataset(d, index=build_index(d)),
                       global_batch=4, seed=0, num_steps=3,
                       wait_timeout=0.1, stall_retries=0)
    it = iter(ld)
    next(it)
    with pytest.raises(LoaderStallError, match="on batch 1"):
        next(it)


def test_stall_retries_heal_a_transient_hiccup(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [8, 8])
    slow = {"done": False}

    def tf(b, s):
        if s == 0 and not slow["done"]:
            slow["done"] = True
            time.sleep(0.3)
        return b

    ld = ShardedLoader(ShardedDataset(d, index=build_index(d)),
                       global_batch=4, seed=0, num_steps=3, transform=tf,
                       wait_timeout=0.05, stall_retries=5)
    assert len(list(iter(ld))) == 3


def test_stall_retries_exhausted_still_typed_error(tmp_path):
    d = str(tmp_path)
    _write_shards(d, [8, 8])

    def tf(b, s):
        time.sleep(2)                        # a wedged fill
        return b

    ld = ShardedLoader(ShardedDataset(d, index=build_index(d)),
                       global_batch=4, seed=0, num_steps=2, transform=tf,
                       wait_timeout=0.05, stall_retries=2)
    t0 = time.perf_counter()
    with pytest.raises(LoaderStallError, match="no batch within"):
        next(iter(ld))
    assert time.perf_counter() - t0 >= 0.2


def test_sources_validate_like_jax():
    from apex_tpu.data import loader as jloader
    src = data.ArraySource(np.arange(12, dtype=np.float64).reshape(4, 3),
                           labels=np.arange(4))
    jsrc = jloader.ArraySource(np.arange(12, dtype=np.float64).reshape(4, 3),
                               labels=np.arange(4))
    assert src.data.dtype == np.float32 and src.labels.dtype == np.int32
    np.testing.assert_array_equal(src.data, jsrc.data)
    assert src.shape == jsrc.shape and src.sample_bytes == jsrc.sample_bytes
    syn = data.SyntheticSource(shape=(4, 4, 3), n_classes=7)
    assert syn.sample_bytes == jloader.SyntheticSource(
        shape=(4, 4, 3), n_classes=7).sample_bytes


# ---------------------------------------------------------------------------
# across the packages: one directory, the same stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_json_and_digest_match_jax(writer, tmp_path):
    d = str(tmp_path)
    _write_shards(d, [11, 9, 12, 8], images=True)
    (jsharded.build_index if writer == "jax" else build_index)(d)
    doc = (tmp_path / "INDEX.json").read_bytes()
    other = jsharded.build_index if writer == "port" else build_index
    idx = other(d)
    assert (tmp_path / "INDEX.json").read_bytes() == doc
    assert load_index(d).digest == jsharded.load_index(d).digest == \
        idx.digest
    assert load_index(d).keys == jsharded.load_index(d).keys


def test_addressing_matches_jax():
    for n, gb in [(40, 8), (113, 24), (1024, 128)]:
        for seed in (0, 5):
            for step in (0, 1, n // gb, 3 * (n // gb) + 2):
                np.testing.assert_array_equal(
                    global_records(seed, step, n, gb),
                    jsharded.global_records(seed, step, n, gb))
                for world in (1, 2, 4, 8):
                    if gb % world:
                        continue
                    for host in range(world):
                        np.testing.assert_array_equal(
                            host_records(seed, step, n, gb, world, host),
                            jsharded.host_records(seed, step, n, gb, world,
                                                  host))


@pytest.mark.parametrize("world,start", [(1, 0), (1, 5), (2, 3), (4, 7)])
def test_loader_batches_match_jax(world, start, tmp_path):
    d = str(tmp_path)
    _write_shards(d, [11, 9, 12, 8], images=True, seed=3)
    build_index(d)
    for host in range(world):
        kw = dict(global_batch=8, seed=6, world=world, host=host,
                  num_steps=12)
        pl = ShardedLoader(open_dataset(d), **kw)
        jl = jsharded.ShardedLoader(jsharded.open_dataset(d), **kw)
        assert pl.data_meta() == jl.data_meta()
        assert pl.index_digest == jl.index_digest
        pl.seek(start)
        jl.seek(start)
        for s, (a, b) in enumerate(zip(iter(pl), iter(jl)), start):
            assert sorted(a) == sorted(b) == ["images", "labels"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes(), (s, k)
            assert pl.cursor(s) == jl.cursor(s)
            assert pl(s)["images"].tobytes() == a["images"].tobytes()
