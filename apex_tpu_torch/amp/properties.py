"""Opt-level properties: the O0-O5 presets.

Counterpart of ``apex_tpu/amp/properties.py``.  ``Properties`` is a
validated options bag; each preset fills it.  bf16 modes (O4/O5) keep loss
scale 1: bf16 shares fp32's exponent range.  Dtypes are ``torch.dtype``s.
"""
from __future__ import annotations

import torch

__all__ = ["Properties", "opt_levels", "O0", "O1", "O2", "O3", "O4", "O5"]

_ALLOWED = {
    "enabled", "opt_level", "cast_model_type", "patch_functions",
    "patch_functions_type", "keep_batchnorm_fp32", "master_weights",
    "loss_scale", "flash_attn_backward",
}


def _flash_backwards():
    from ..contrib.multihead_attn.flash import BACKWARD_IMPLS
    return BACKWARD_IMPLS


def _as_dtype(value):
    if value is None or value is False:
        return value
    if isinstance(value, str):
        value = getattr(torch, value, None)
    if not isinstance(value, torch.dtype):
        raise TypeError(f"expected a torch dtype, got {value!r}")
    return value


class Properties:
    """Mutable options bag, validated on every set."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "patch_functions": False,
            "patch_functions_type": None,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
            "flash_attn_backward": "auto",
        }

    def __getattr__(self, name):
        if "options" in self.__dict__ and name in self.__dict__["options"]:
            return self.options[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if "options" not in self.__dict__:
            super().__setattr__(name, value)
            return
        if name not in self.options:
            raise AttributeError(f"Tried to set unexpected option {name}; "
                                 f"valid: {sorted(_ALLOWED)}")
        if name == "cast_model_type":
            if self.opt_level == "O1" and value not in (None, False):
                raise RuntimeError(
                    "O1 inserts casts around ops, so the model weights "
                    "themselves should remain fp32 (cast_model_type must be "
                    "None/False with O1).")
            value = _as_dtype(value)
        elif name == "patch_functions_type":
            value = _as_dtype(value)
        elif name == "loss_scale":
            value = value if value == "dynamic" else float(value)
        elif name == "flash_attn_backward":
            value = "auto" if value is None else value
            if value not in _flash_backwards():
                raise ValueError(f"flash_attn_backward must be one of "
                                 f"{_flash_backwards()}, got {value!r}")
        self.options[name] = value

    def __repr__(self):
        return "Properties(" + ", ".join(
            f"{k}={v}" for k, v in self.options.items()) + ")"


class _Preset:
    """An opt level: ``preset(properties)`` fills and returns
    ``properties``.  ``_values`` is (opt_level, cast_model_type,
    patch_functions, patch_functions_type, keep_batchnorm_fp32,
    master_weights, loss_scale)."""
    brief = ""
    _values: tuple = ()

    def __call__(self, properties: Properties) -> Properties:
        (properties.opt_level, properties.cast_model_type,
         properties.patch_functions, properties.patch_functions_type,
         properties.keep_batchnorm_fp32, properties.master_weights,
         properties.loss_scale) = self._values
        properties.enabled = True
        return properties


class O0(_Preset):
    brief = "O0:  Pure FP32 training."
    _values = ("O0", torch.float32, False, None, None, False, 1.0)


class O1(_Preset):
    brief = "O1:  Insert automatic casts around torch functions (fp16)."
    _values = ("O1", None, True, torch.float16, None, None, "dynamic")


class O2(_Preset):
    brief = "O2:  FP16 training with FP32 batchnorm and FP32 master weights."
    _values = ("O2", torch.float16, False, None, True, True, "dynamic")


class O3(_Preset):
    brief = "O3:  Pure FP16 training."
    _values = ("O3", torch.float16, False, None, False, False, 1.0)


class O4(_Preset):
    brief = "O4:  Insert automatic casts around torch functions (bf16)."
    _values = ("O4", None, True, torch.bfloat16, None, None, 1.0)


class O5(_Preset):
    brief = ("O5:  BFLOAT16 training with FP32 batchnorm and FP32 master "
             "weights.")
    _values = ("O5", torch.bfloat16, False, None, True, True, 1.0)


# Mirrors the JAX package's (and the reference's) opt_levels table.
opt_levels = {c.__name__: c() for c in (O0, O1, O2, O3, O4, O5)}
