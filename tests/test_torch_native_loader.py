"""The port's native prefetch loader against the JAX package's.

``apex_tpu_torch.data.NativeLoader`` (its own copy of the C++ ring,
``apex_tpu_torch/csrc/prefetch.cpp``, built with the host compiler) and
``apex_tpu.data.NativeLoader`` read the same memmapped ``.npy`` files and
must hand out the same batches in the same order: bit for bit, for 1 and
4 fill workers, across epoch boundaries (a new permutation each epoch),
on the ring and on the Python engine each package falls back to without
its library.  An injected ``loader_stall`` inside the timed wait and a
wedged producer raise ``LoaderStallError`` in both packages at the same
batch.  Both loaders are asked for numpy copies (``device_put=False``):
the port's pinned tensors need the card (a card test covers them).
"""
import numpy as np
import pytest

from apex_tpu.data import loader as jloader
from apex_tpu.resilience import faults as jfaults

from apex_tpu_torch.data import loader as ploader
from apex_tpu_torch.resilience import faults

N, SHAPE, BATCH = 10, (3, 4), 4          # 2 batches an epoch, 2 ragged rows


@pytest.fixture(autouse=True)
def _no_installed_plan():
    prev, jprev = faults.install(None), jfaults.install(None)
    yield
    faults.install(prev)
    jfaults.install(jprev)


@pytest.fixture
def memmaps(tmp_path):
    """(port source, JAX source) over the same memmapped files."""
    rng = np.random.default_rng(0)
    np.save(tmp_path / "images.npy",
            rng.standard_normal((N,) + SHAPE).astype(np.float32))
    np.save(tmp_path / "labels.npy",
            rng.integers(0, 100, N).astype(np.int32))
    srcs = []
    for mod in (ploader, jloader):
        srcs.append(mod.ArraySource(
            data=np.load(tmp_path / "images.npy", mmap_mode="r"),
            labels=np.load(tmp_path / "labels.npy", mmap_mode="r")))
    return srcs


def _batches(mod, src, steps, **kw):
    return list(mod.NativeLoader(src, batch_size=BATCH, steps=steps, seed=5,
                                 device_put=False, **kw))


def _python_engine(monkeypatch):
    monkeypatch.setattr(ploader, "_load", lambda: None)
    monkeypatch.setattr(jloader, "_load", lambda: None)


def test_native_library_builds_here():
    """The ring builds with the host compiler alone (no nvcc)."""
    assert ploader.native_available()
    assert jloader.native_available()


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("threads", [1, 4])
def test_batches_equal_the_jax_loader(memmaps, threads, engine,
                                      monkeypatch):
    """Five batches (two and a half epochs) equal the JAX loader's, in
    order; each epoch is a permutation of the rows and the next epoch is
    another one."""
    if engine == "python":
        _python_engine(monkeypatch)
    src, jsrc = memmaps
    got = _batches(ploader, src, 5, threads=threads)
    ref = _batches(jloader, jsrc, 5, threads=threads)
    assert len(got) == len(ref) == 5
    for (x, y), (jx, jy) in zip(got, ref):
        assert x.dtype == np.float32 and y.dtype == np.int32
        assert x.shape == (BATCH,) + SHAPE and y.shape == (BATCH,)
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    data = np.asarray(src.data)
    rows = [[int(np.flatnonzero((data == r).all(axis=(1, 2)))[0])
             for r in x] for x, _ in got]
    for e in (0, 1):
        epoch = rows[2 * e] + rows[2 * e + 1]
        assert len(set(epoch)) == 2 * BATCH       # no row twice an epoch
    assert rows[0] + rows[1] != rows[2] + rows[3]  # reshuffled


@pytest.mark.parametrize("threads", [1, 4])
def test_worker_count_does_not_change_the_stream(memmaps, threads):
    src, _ = memmaps
    one = _batches(ploader, src, 6, threads=1)
    many = _batches(ploader, src, 6, threads=threads)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(one, many))


@pytest.mark.parametrize("engine", ["native", "python"])
def test_synthetic_source_equals_the_jax_loader(engine, monkeypatch):
    if engine == "python":
        _python_engine(monkeypatch)
    got = _batches(ploader, ploader.SyntheticSource((5,), 7), 3)
    ref = _batches(jloader, jloader.SyntheticSource((5,), 7), 3)
    for (x, y), (jx, jy) in zip(got, ref):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert (np.abs(x) <= 1).all() and ((0 <= y) & (y < 7)).all()


@pytest.mark.parametrize("engine", ["native", "python"])
def test_loader_stall_fault_trips_wait_timeout(memmaps, engine,
                                               monkeypatch):
    """``loader_stall@1:0.3`` with ``wait_timeout`` 0.1: batch 0 comes,
    batch 1 raises the typed error in both packages."""
    if engine == "python":
        _python_engine(monkeypatch)
    for mod, fmod, src in ((ploader, faults, memmaps[0]),
                           (jloader, jfaults, memmaps[1])):
        fmod.install(fmod.parse("loader_stall@1:0.3"))
        it = iter(mod.NativeLoader(src, batch_size=BATCH, steps=4,
                                   device_put=False, wait_timeout=0.1))
        next(it)
        with pytest.raises(mod.LoaderStallError, match="stalled"):
            next(it)
        it.close()


@pytest.mark.parametrize("engine", ["native", "python"])
def test_loader_stall_without_timeout_just_delays(memmaps, engine,
                                                  monkeypatch):
    if engine == "python":
        _python_engine(monkeypatch)
    faults.install(faults.parse("loader_stall@0:0.05"))
    src, jsrc = memmaps
    got = _batches(ploader, src, 3)
    ref = _batches(jloader, jsrc, 3)
    assert len(got) == 3
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(got, ref))


def test_wait_timeout_on_a_wedged_producer(memmaps, monkeypatch):
    """A producer that never fills the queue trips the bounded wait
    instead of hanging the loop (the Python engine)."""
    _python_engine(monkeypatch)
    monkeypatch.setattr(ploader, "_put_checking_stop",
                        lambda q, item, stop: stop.wait(10))
    loader = ploader.NativeLoader(memmaps[0], batch_size=BATCH, steps=2,
                                  device_put=False, wait_timeout=0.1,
                                  stall_retries=1)
    with pytest.raises(ploader.LoaderStallError, match="no batch within"):
        next(iter(loader))


def test_pinned_output_needs_the_card(memmaps):
    """``device_put=True`` (the default) hands out pinned tensors, which
    need the card: on a host without one the first batch raises instead
    of handing out pageable memory."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("the card test covers the pinned path")
    it = iter(ploader.NativeLoader(memmaps[0], batch_size=BATCH, steps=1))
    with pytest.raises(RuntimeError):
        next(it)
    it.close()
