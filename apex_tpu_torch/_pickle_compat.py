"""The pickle dialect both packages' checkpoint files share.

A checkpoint's payload is a pickle of numpy leaves (``checkpoint.save``).
The JAX package writes two kinds of name into it that this package cannot
import where it runs: its optimizer states (``apex_tpu.optimizers.
fused_adam.FusedAdamState`` ...) and ``ml_dtypes.bfloat16``, the numpy
dtype of its bf16 leaves.  This module reads and writes those names
without importing either package:

- :class:`Unpickler` maps each name of :data:`STATE_CLASSES` to this
  package's class of the same fields, refuses any other ``apex_tpu``
  name (it never imports one), and reads ``ml_dtypes.bfloat16`` as
  :data:`BF16`, a 2-byte structured dtype that no other leaf has.
- :class:`Pickler` writes this package's state classes under the JAX
  names and a :data:`BF16` array as the opcodes numpy gives an
  ``ml_dtypes.bfloat16`` array (``_reconstruct(ndarray, (0,), b'b')``,
  then ``__setstate__`` with ``numpy.dtype(ml_dtypes.bfloat16, False,
  True)``), so the JAX package loads a real bf16 array.

Both are Python's pure-Python pickle classes with the few names above
rerouted; every other object pickles as ``pickle`` does.  numpy's own
names are numpy 2's (``numpy._core``), so reading a file needs numpy 2.
"""
from __future__ import annotations

import importlib
import pickle

import numpy as np

__all__ = ["BF16", "STATE_CLASSES", "Pickler", "Unpickler",
           "bf16_to_numpy", "is_bf16"]

#: bf16 bits as numpy holds them here: one little-endian uint16 field
#: named "bfloat16".
BF16 = np.dtype([("bfloat16", "<u2")])

#: The JAX package's state classes -> this package's module and class of
#: the same name and fields.
STATE_CLASSES = {
    ("apex_tpu.optimizers.fused_adam", "FusedAdamState"):
        ("apex_tpu_torch.optimizers.fused_adam", "FusedAdamState"),
    ("apex_tpu.optimizers.fused_lamb", "FusedLAMBState"):
        ("apex_tpu_torch.optimizers.fused_lamb", "FusedLAMBState"),
    ("apex_tpu.optimizers.fused_sgd", "FusedSGDState"):
        ("apex_tpu_torch.optimizers.fused_sgd", "FusedSGDState"),
    ("apex_tpu.optimizers.fused_adagrad", "FusedAdagradState"):
        ("apex_tpu_torch.optimizers.fused_adagrad", "FusedAdagradState"),
    ("apex_tpu.optimizers.fused_novograd", "FusedNovoGradState"):
        ("apex_tpu_torch.optimizers.fused_novograd", "FusedNovoGradState"),
}

# ml_dtypes.bfloat16's dtype state as numpy pickles it: (version, byte
# order, subarray, names, fields, itemsize, alignment, flags).
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)
_RECONSTRUCT = np.zeros(1, np.uint8).__reduce__()[0]


class _Bf16Type:
    """Stands for ``ml_dtypes.bfloat16`` (the scalar type) in a stream."""


def is_bf16(a) -> bool:
    return isinstance(a, np.ndarray) and a.dtype == BF16


def bf16_to_numpy(bits: np.ndarray) -> np.ndarray:
    """A uint16 / int16 array of bf16 bits as a :data:`BF16` array."""
    return np.ascontiguousarray(bits).view(np.uint16).view(BF16)


def _state_class(module: str, name: str):
    mod, cls = STATE_CLASSES[(module, name)]
    return getattr(importlib.import_module(mod), cls)


def _jax_name(obj):
    """(module, name) the JAX package knows ``obj`` by, or None."""
    if obj is _Bf16Type:
        return "ml_dtypes", "bfloat16"
    for jax_name, (mod, cls) in STATE_CLASSES.items():
        if getattr(obj, "__module__", None) == mod \
                and getattr(obj, "__qualname__", None) == cls:
            return jax_name
    return None


def _dtype(obj, align=False, copy=False):
    """``numpy.dtype`` as a stream calls it, with :data:`BF16` for the
    bf16 type."""
    if obj is _Bf16Type:
        return BF16
    return np.dtype(obj, align, copy)


class Pickler(pickle._Pickler):
    """Writes the JAX package's names for this package's state classes
    and for :data:`BF16` arrays."""

    def reducer_override(self, obj):
        if is_bf16(obj):
            a = np.ascontiguousarray(obj)
            return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, a.shape, BF16, False, a.view(np.uint16).tobytes()))
        if isinstance(obj, np.dtype) and obj == BF16:
            return np.dtype, (_Bf16Type, False, True), _BF16_DTYPE_STATE
        return NotImplemented

    def save_global(self, obj, name=None):
        target = _jax_name(obj)
        if target is None:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _load_build(self):
    """BUILD, except the bf16 dtype's own state, which would rewrite the
    shared :data:`BF16` object: it is checked and dropped."""
    if self.stack[-2] is BF16:
        state = self.stack.pop()
        if tuple(state)[5:7] != (2, 2):
            raise pickle.UnpicklingError(f"bad bfloat16 dtype state {state}")
        return
    pickle._Unpickler.load_build(self)


class Unpickler(pickle._Unpickler):
    """Reads either package's names (see the module docstring)."""

    dispatch = dict(pickle._Unpickler.dispatch)
    dispatch[pickle.BUILD[0]] = _load_build

    def find_class(self, module, name):
        if (module, name) in STATE_CLASSES:
            return _state_class(module, name)
        if module == "apex_tpu" or module.startswith("apex_tpu."):
            raise pickle.UnpicklingError(
                f"the payload names {module}.{name}, which has no "
                "counterpart in apex_tpu_torch (known: "
                f"{sorted(m + '.' + n for m, n in STATE_CLASSES)})")
        if module == "ml_dtypes":
            if name != "bfloat16":
                raise pickle.UnpicklingError(
                    f"unsupported dtype ml_dtypes.{name}")
            return _Bf16Type
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        return super().find_class(module, name)
