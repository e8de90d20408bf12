"""Multi-tensor apply: the flat-buffer engine and its kernels
(counterpart of ``apex_tpu/multi_tensor_apply``).

``multi_tensor_applier(op, tensor_lists, *args)`` packs each list of
tensors into one flat fp32 buffer (:class:`TreeFlattener`) and calls
``op`` on the flat buffers; it returns ``(op's result, the flattener of
the last list)``, whose ``unflatten`` gives the tensors back.  The
reference's ``noop_flag`` is the kernels' returned overflow flag.
"""
from . import kernels  # noqa: F401
from .flattener import DEFAULT_CHUNK, LANE, TreeFlattener  # noqa: F401
from .kernels import (fused_adam_flat, fused_lamb_stage1_flat,  # noqa: F401
                      multi_tensor_axpby, multi_tensor_l2norm,
                      multi_tensor_l2norm_reference, multi_tensor_scale)


class MultiTensorApply:
    """Callable facade (the reference's ``MultiTensorApply``): packs each
    tensor list on the fly.  Steady-state training keeps its state flat and
    calls the ``*_flat`` kernels itself, as the fused optimizers do."""

    available = True

    def __init__(self, chunk_size: int = DEFAULT_CHUNK):
        self.chunk_size = chunk_size

    def __call__(self, op, tensor_lists, *args, **kwargs):
        flats = []
        flattener = None
        for lst in tensor_lists:
            flattener = TreeFlattener(list(lst), chunk=self.chunk_size)
            flats.append(flattener.flatten(list(lst)))
        return op(*flats, *args, **kwargs), flattener


multi_tensor_applier = MultiTensorApply()
