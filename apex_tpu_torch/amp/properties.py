"""Opt-level properties: the O0-O5 presets.

Counterpart of ``apex_tpu/amp/properties.py``.  ``Properties`` is a
validated options bag; each preset fills it.  bf16 modes (O4/O5) keep loss
scale 1: bf16 shares fp32's exponent range.  Dtypes are ``torch.dtype``s.
"""
from __future__ import annotations

import torch

__all__ = ["Properties", "opt_levels"]

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


def _preset(opt_level, cast_model_type, patch_functions, patch_type,
            keep_bn, master_weights, loss_scale):
    def apply(properties: Properties) -> Properties:
        properties.enabled = True
        properties.opt_level = opt_level
        properties.cast_model_type = cast_model_type
        properties.patch_functions = patch_functions
        properties.patch_functions_type = patch_type
        properties.keep_batchnorm_fp32 = keep_bn
        properties.master_weights = master_weights
        properties.loss_scale = loss_scale
        return properties
    return apply


# Mirrors the JAX package's (and the reference's) opt_levels table.
opt_levels = {
    "O0": _preset("O0", torch.float32, False, None, None, False, 1.0),
    "O1": _preset("O1", None, True, torch.float16, None, None, "dynamic"),
    "O2": _preset("O2", torch.float16, False, None, True, True, "dynamic"),
    "O3": _preset("O3", torch.float16, False, None, False, False, 1.0),
    "O4": _preset("O4", None, True, torch.bfloat16, None, None, 1.0),
    "O5": _preset("O5", torch.bfloat16, False, None, True, True, 1.0),
}
