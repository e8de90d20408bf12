"""Parameter-list helpers (counterpart of
``apex_tpu/fp16_utils/fp16util.py``, the reference's ``fp16util.py``)."""
from __future__ import annotations

import torch

from ..multi_tensor_apply.flattener import TreeFlattener
from ..utils import pytree as _pt

__all__ = ["tofp16", "network_to_half", "convert_network",
           "prep_param_lists", "master_params_to_model_params",
           "model_grads_to_master_grads"]


def tofp16(params):
    """``network.half()``: every floating leaf in fp16."""
    return _pt.cast_tree(params, torch.float16)


def network_to_half(params):
    """Blind fp16 conversion: every floating leaf in fp16."""
    return _pt.cast_tree(params, torch.float16)


def convert_network(params, dtype, keep_batchnorm_fp32=True):
    """Batch-norm-safe conversion: normalization leaves (by path) stay fp32
    when ``keep_batchnorm_fp32``."""
    return _pt.convert_network(params, dtype, keep_batchnorm_fp32)


def prep_param_lists(params, flat_master=False):
    """(model_params, master_params): fp32 master copies of the leaves, or
    with ``flat_master`` a ``(TreeFlattener, flat fp32 buffer)`` pair."""
    if flat_master:
        fl = TreeFlattener(params)
        return params, (fl, fl.flatten(params))
    return params, _pt.master_params_from(params)


def master_params_to_model_params(model_params, master_params):
    """fp32 masters (a tree or the flat pair) -> copies in the model
    leaves' dtypes."""
    if isinstance(master_params, tuple) and len(master_params) == 2 and \
            isinstance(master_params[0], TreeFlattener):
        fl, flat = master_params
        return _pt.tree_cast_like(fl.unflatten(flat), model_params)
    return _pt.master_to_model(master_params, model_params)


def model_grads_to_master_grads(model_grads, master_like=None):
    """Model-precision gradients -> fp32."""
    del master_like
    return _pt.tree_map(lambda g: g.to(torch.float32), model_grads)
