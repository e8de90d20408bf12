"""The O1 / O4 casts: per-op cast insertion for PyTorch.

Counterpart of ``apex_tpu/amp/amp.py``.  The JAX package patches
``jax.numpy`` / ``jax.lax`` / ``jax.nn`` attributes with cast wrappers;
here one :class:`torch.overrides.TorchFunctionMode` sees every torch call,
looks its callable up by identity in the lists of
:mod:`.lists.torch_overrides`, applies that list's wrapper from
:mod:`.wrap`, and passes every other call through.  So the casts are the
same on the CPU and on the card, and they reach a listed function however
it was imported.  Tensor methods and operators are not cast, as a JAX
``Array``'s are not.

``init`` enters the mode in the calling thread and ``uninit`` leaves it
(torch keeps function modes per thread); both are reversible, and
``autocast(dtype)`` is the scoped form::

    with amp.autocast(torch.bfloat16):
        loss = model(params, x)

Functions registered with ``register_*_function(module, name)`` are
patched as module attributes at ``init``, as the JAX package patches them.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.overrides import TorchFunctionMode, _get_current_function_mode_stack

from . import wrap
from .lists import torch_overrides as L
from .properties import _as_dtype

__all__ = ["init", "uninit", "is_initialized", "autocast", "disable_casts",
           "half_function", "bfloat16_function", "float_function",
           "promote_function", "register_half_function",
           "register_bfloat16_function", "register_float_function",
           "register_promote_function"]

# --- user registries ---------------------------------------------------------

_user_cast_entries = []   # (module, name, category)


def register_half_function(module, name):
    _user_cast_entries.append((module, name, "low_prec"))


# bf16 and fp16 share the low-precision category; init()'s patch_type picks
# the dtype
register_bfloat16_function = register_half_function


def register_float_function(module, name):
    _user_cast_entries.append((module, name, "fp32"))


def register_promote_function(module, name):
    _user_cast_entries.append((module, name, "promote"))


# --- decorators --------------------------------------------------------------

def half_function(fn):
    """Run ``fn`` with its inputs cast to the active low-precision type
    while the casts are on (unchanged otherwise)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _state["patch_type"] is not None:
            return wrap.make_cast_wrapper(fn, _state["patch_type"])(
                *args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper


bfloat16_function = half_function


def float_function(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _state["patch_type"] is not None:
            return wrap.make_cast_wrapper(fn, torch.float32)(*args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper


def promote_function(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _state["patch_type"] is not None:
            return wrap.make_promote_wrapper(fn)(*args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper


# --- the mode ----------------------------------------------------------------

_state = {"patch_type": None, "allow_banned": False, "mode": None,
          "saved": []}


class _CastMode(TorchFunctionMode):
    """Calls a listed callable through its wrapper; every other call as
    it came.  Inside ``__torch_function__`` torch leaves the mode, so the
    wrapper's own torch calls are not seen again."""

    def __init__(self, table):
        super().__init__()
        self.table = table

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            wrapped = self.table.get(func)
        except TypeError:             # an unhashable callable
            wrapped = None
        if wrapped is None:
            return func(*args, **kwargs)
        return wrapped(*args, **kwargs)


def _cast_table(patch_type, allow_banned):
    """{callable: wrapper}; a callable keeps its first category, as a
    function the JAX package has patched once is not patched again."""
    table = {}
    for fns in L.LOW_PREC.values():
        for f in fns:
            table.setdefault(f, wrap.make_cast_wrapper(f, patch_type))
    for fns in L.FP32.values():
        for f in fns:
            table.setdefault(f, wrap.make_cast_wrapper(
                f, torch.float32,
                result_dtype=torch.float32 if f in L.FP64_RESULT else None))
    for fns in L.CASTS.values():
        for f in fns:
            table.setdefault(f, wrap.make_promote_wrapper(f))
    for fns in L.SEQUENCE_CASTS.values():
        for f in fns:
            table.setdefault(f, wrap.make_sequence_promote_wrapper(f))
    if not allow_banned:
        for f, msg in L.BANNED_FUNCS:
            table.setdefault(f, wrap.make_banned_wrapper(
                f, getattr(f, "__name__", repr(f)), msg))
    return table


def _patch(module, name, wrapper_factory, *factory_args):
    if not hasattr(module, name):
        return
    orig = getattr(module, name)
    if hasattr(orig, "__amp_orig__"):          # already patched
        return
    _state["saved"].append((module, name, orig))
    setattr(module, name, wrapper_factory(orig, *factory_args))


def init(patch_type=torch.float16, enable_casts=True, allow_banned=False):
    """Turn the casts on in the calling thread: ``patch_type`` fp16 (O1)
    or bf16 (O4) for the low-precision list."""
    if not enable_casts:
        return
    patch_type = _as_dtype(patch_type)
    if _state["patch_type"] is not None:
        if _state["patch_type"] == patch_type:
            return
        uninit()
    table = _cast_table(patch_type, allow_banned)
    mode = _CastMode(table)
    mode.__enter__()
    _state.update(patch_type=patch_type, allow_banned=allow_banned,
                  mode=mode)
    for module, name, category in _user_cast_entries:
        if getattr(module, name, None) in table:
            continue                           # listed already
        if category == "low_prec":
            _patch(module, name, wrap.make_cast_wrapper, patch_type)
        elif category == "fp32":
            _patch(module, name, wrap.make_cast_wrapper, torch.float32)
        else:
            _patch(module, name, wrap.make_promote_wrapper)


def uninit():
    """Turn the casts off: leave the mode (it must be the innermost
    function mode of this thread) and restore the patched attributes."""
    mode = _state["mode"]
    if mode is not None:
        stack = _get_current_function_mode_stack()
        if not stack or stack[-1] is not mode:
            raise RuntimeError(
                "amp.uninit: the casts' mode is not the innermost torch "
                "function mode of this thread (another mode entered after "
                "amp.init is still active, or init ran in another thread)")
        mode.__exit__(None, None, None)
    for module, name, orig in reversed(_state["saved"]):
        setattr(module, name, orig)
    _state["saved"].clear()
    _state.update(patch_type=None, allow_banned=False, mode=None)


def is_initialized():
    return _state["patch_type"] is not None


@contextlib.contextmanager
def autocast(dtype=torch.bfloat16):
    """The casts on for the block, with ``dtype`` as the low-precision
    type; the state before the block is restored after it."""
    was, banned = _state["patch_type"], _state["allow_banned"]
    init(patch_type=dtype)
    try:
        yield
    finally:
        uninit()
        if was is not None:
            init(patch_type=was, allow_banned=banned)


@contextlib.contextmanager
def disable_casts():
    """The casts off for the block (around an optimizer step, so the
    master-weight math stays fp32), back on after it."""
    ptype, banned = _state["patch_type"], _state["allow_banned"]
    uninit()
    try:
        yield
    finally:
        if ptype is not None:
            init(patch_type=ptype, allow_banned=banned)
