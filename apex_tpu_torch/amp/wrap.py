"""Cast-wrapper factories for the O1 / O4 casts.

Counterpart of ``apex_tpu/amp/wrap.py``, with its rules: only floating
tensors among the top-level positional and keyword arguments are cast;
integer and bool tensors, Python scalars and everything else pass
through.  There is no cast cache: each call casts its own arguments, as
the JAX package's wrappers do.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["make_cast_wrapper", "make_promote_wrapper",
           "make_sequence_promote_wrapper", "make_banned_wrapper"]


def _is_float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast(x, dtype):
    if _is_float_tensor(x) and x.dtype != dtype:
        return x.to(dtype)
    return x


def make_cast_wrapper(orig_fn, dtype, *, result_dtype=None):
    """Cast every floating tensor argument to ``dtype`` before calling.
    Applied to the low-precision and fp32 lists alike.  ``result_dtype``
    casts a floating result too (for a function that computes in another
    dtype whatever its inputs', ``torch.float_power``)."""
    @functools.wraps(orig_fn)
    def wrapper(*args, **kwargs):
        args = [_cast(a, dtype) for a in args]
        kwargs = {k: _cast(v, dtype) for k, v in kwargs.items()}
        out = orig_fn(*args, **kwargs)
        return out if result_dtype is None else _cast(out, result_dtype)
    wrapper.__amp_orig__ = orig_fn
    return wrapper


def _widest_type(xs):
    widest = None
    for x in xs:
        if _is_float_tensor(x):
            widest = x.dtype if widest is None \
                else torch.promote_types(widest, x.dtype)
    return widest


def make_promote_wrapper(orig_fn):
    """Promote the floating positional arguments to their widest type."""
    @functools.wraps(orig_fn)
    def wrapper(*args, **kwargs):
        widest = _widest_type(args)
        if widest is not None:
            args = [_cast(a, widest) for a in args]
        return orig_fn(*args, **kwargs)
    wrapper.__amp_orig__ = orig_fn
    return wrapper


def make_sequence_promote_wrapper(orig_fn):
    """Promote every element of the leading list / tuple argument
    (``cat``, ``stack``) to its widest floating type."""
    @functools.wraps(orig_fn)
    def wrapper(seq, *args, **kwargs):
        if isinstance(seq, (list, tuple)):
            widest = _widest_type(seq)
            if widest is not None:
                seq = type(seq)(_cast(x, widest) for x in seq)
        return orig_fn(seq, *args, **kwargs)
    wrapper.__amp_orig__ = orig_fn
    return wrapper


def make_banned_wrapper(orig_fn, name, message):
    """Raise on use under the casts."""
    @functools.wraps(orig_fn)
    def wrapper(*args, **kwargs):
        raise RuntimeError(
            f"amp does not support {name} under autocast. {message}")
    wrapper.__amp_orig__ = orig_fn
    return wrapper
