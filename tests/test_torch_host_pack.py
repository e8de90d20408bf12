"""The port's host packing (``apex_tpu_torch.utils.host_pack`` over its own
``apex_tpu_torch/csrc/host_pack.cpp``) against the JAX package's.

The cases of ``tests/L0/test_interop.py:142-200`` run through both
packages on the same arrays: the buffers are equal bit for bit, the
padding stays zero, a reused ``out`` keeps its gaps, and the same layouts
raise.  The numpy copy (no host compiler) gives the same bits; the
library is the port's own, built apart from the ``nvcc`` sources.
"""
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply.flattener import \
    TreeFlattener as JTreeFlattener
from apex_tpu.utils import host_pack as jhp

from apex_tpu_torch.multi_tensor_apply.flattener import TreeFlattener
from apex_tpu_torch.utils import build
from apex_tpu_torch.utils import host_pack as hp


@pytest.fixture(params=["native", "numpy"])
def mode(request, monkeypatch):
    """Each case through the built library and through the numpy copy."""
    if request.param == "numpy":
        monkeypatch.setattr(build, "host_pack_library", lambda: None)
    else:
        assert hp.native_available()
    return request.param


def _arrays(sizes, seed=0):
    return [np.random.RandomState(seed + i).randn(n).astype(np.float32)
            for i, n in enumerate(sizes)]


def test_native_library_is_the_ports_own():
    lib = build.host_pack_library()
    assert lib is not None and lib.apex_torch_host_pack_abi() == 1
    res = build.build_host(build.HOST_PACK_SOURCE)
    assert res.path.name == "libapex_tpu_torch_host_pack.so"
    assert res.path.parent.parent == build.BUILD_ROOT / "host"
    # host code stays out of the nvcc sources (and so out of their hash)
    assert all(p.suffix == ".cu" for p in build.sources())
    assert build.HOST_PACK_SOURCE.exists()


@pytest.mark.parametrize("sizes,offsets,total", [
    ([5, 128, 300], [0, 128, 256], 640),
    ([1], [0], 128),
    ([700_000, 300_001, 3], [0, 700_032, 1_000_064], 1_000_192),
])
def test_round_trip_matches_jax_bitwise(mode, sizes, offsets, total):
    arrays = _arrays(sizes)
    flat = hp.pack(arrays, offsets, total)
    jflat = jhp.pack(arrays, offsets, total)
    assert flat.dtype == np.float32 and flat.shape == (total,)
    np.testing.assert_array_equal(flat, jflat)
    # the padding gaps stay zero
    mask = np.ones(total, bool)
    for a, off in zip(arrays, offsets):
        mask[off:off + a.size] = False
    assert not flat[mask].any()
    outs = [np.zeros_like(a) for a in arrays]
    hp.unpack(flat, outs, offsets)
    jouts = [np.zeros_like(a) for a in arrays]
    jhp.unpack(jflat, jouts, offsets)
    for a, o, j in zip(arrays, outs, jouts):
        np.testing.assert_array_equal(o, a)
        np.testing.assert_array_equal(o, j)


def test_pack_casts_to_the_dtype_and_keeps_shapes(mode):
    arrays = [np.arange(12, dtype=np.float64).reshape(3, 4),
              np.ones((2, 2), np.int32)]
    flat = hp.pack(arrays, [0, 128], 256, dtype=np.float32)
    np.testing.assert_array_equal(flat, jhp.pack(arrays, [0, 128], 256))
    outs = [np.zeros((3, 4), np.float32), np.zeros((2, 2), np.float32)]
    hp.unpack(flat, outs, [0, 128])
    np.testing.assert_array_equal(outs[0], arrays[0])


@pytest.mark.parametrize("bad", ["span_past_total", "negative_offset",
                                 "count_mismatch"])
def test_invalid_layouts_raise_as_jax(mode, bad):
    arrays = _arrays([5, 128, 300])
    offsets, total = [0, 128, 256], 640
    if bad == "span_past_total":
        offsets = [0, 128, 400]
    elif bad == "negative_offset":
        offsets = [-1, 128, 256]
    else:
        offsets = [0, 128]
    for mod in (hp, jhp):
        with pytest.raises(ValueError):
            mod.pack(arrays, offsets, total)
    flat = np.zeros(total, np.float32)
    outs = [np.zeros_like(a) for a in arrays]
    for mod in (hp, jhp):
        with pytest.raises(ValueError):
            mod.unpack(flat, outs, offsets)


def test_out_reuse_and_validation_as_jax(mode):
    arrays = [np.full((4,), 7.0, np.float32)]
    out = np.zeros((128,), np.float32)
    flat = hp.pack(arrays, [0], 128, out=out)
    assert flat is out and (out[:4] == 7.0).all() and (out[4:] == 0).all()
    out[100] = 5.0                        # a gap keeps what it held
    hp.pack([np.full((4,), 3.0, np.float32)], [0], 128, out=out)
    assert (out[:4] == 3.0).all() and out[100] == 5.0
    for kw in (dict(total=64, out=out),
               dict(total=128, dtype=np.float64, out=out),
               dict(total=128, out=np.zeros((256,), np.float32)[::2])):
        total = kw.pop("total")
        for mod in (hp, jhp):
            with pytest.raises(ValueError):
                mod.pack(arrays, [0], total, **kw)


def test_native_unpack_refuses_strided_or_narrow_targets():
    flat = np.zeros(256, np.float32)
    strided = np.zeros((4, 8), np.float32)[:, ::2]
    for mod in (hp, jhp):
        with pytest.raises(ValueError, match="contiguous"):
            mod.unpack(flat, [strided], [0])
        with pytest.raises(ValueError, match="width"):
            mod.unpack(flat, [np.zeros(4, np.float16)], [0])


def test_pack_like_flattener_matches_jax_and_feeds_step_flat(mode):
    """The port's TreeFlattener layout is the JAX one: the packed buffer is
    the JAX package's bits and equals ``TreeFlattener.flatten``."""
    shapes = [(3, 5), (130,), (2, 2, 2), (1,)]
    arrays = [np.random.RandomState(i).randn(*s).astype(np.float32)
              for i, s in enumerate(shapes)]
    fl = TreeFlattener([torch.from_numpy(a) for a in arrays])
    jfl = JTreeFlattener([np.asarray(a) for a in arrays])
    assert fl.total == jfl.total
    np.testing.assert_array_equal(fl.offsets, np.asarray(jfl.offsets))
    flat = hp.pack_like_flattener(arrays, fl)
    np.testing.assert_array_equal(flat, jhp.pack_like_flattener(arrays, jfl))
    np.testing.assert_array_equal(
        flat, fl.flatten([torch.from_numpy(a) for a in arrays]).numpy())
