"""Per-op FLOPs/bytes cost attribution of one call, from its dispatched ops.

Counterpart of the JAX package's ``apex_tpu/telemetry/attrib.py``, with its
op classes, its ``op_table`` / ``collectives_table`` / ``format_op_table``
names and its table shape.  ``pyprof.prof.cost_report`` answers "what does
the whole step cost"; this module is the per-op refinement, the analog of
the reference's ``apex/pyprof/prof`` tables (``blas.py``, ``conv.py``,
``pointwise.py`` ...):

  * the step runs ONCE under a :class:`Recording` (a ``TorchDispatchMode``,
    which autograd carries into its backward), which takes one row per
    dispatched aten op: FLOPs from ``torch.utils.flop_counter``'s formulas
    for the ops it has one for (products, convolutions, attention), else
    from the op's class (elementwise: one per output element; reductions:
    one per input element; data movement: none), and bytes as operand plus
    output bytes (a view moves nothing and counts none);
  * the port's hand kernels are ctypes calls, invisible to dispatch: each
    wrapper reports its launch (:func:`apex_tpu_torch.utils.build
    .launched`), one row with the kernel's name, class ``other``, FLOPs 0
    and operand plus output bytes, as the JAX package's HLO walk gives a
    ``custom-call`` row;
  * each row is binned into :data:`OP_CLASSES` (:func:`op_class` for aten
    ops, :func:`kernel_op_class` for the CUDA kernels of a profiler trace,
    :func:`hlo_op_class` for the JAX package's HLO opcodes) and the table
    rolls up per opcode and per class, with roofline projections against
    ``pyprof.prof``'s ceilings.

Divergences from the JAX module: ``op_table`` RUNS the function (once),
where the JAX one compiles it ahead of time and never runs it; there is no
HLO, so ``parse_hlo`` and ``_compiled_text`` have no counterpart, and the
compiler's module totals (``module_flops`` / ``module_bytes``) are None.
The recording also tracks every storage's lifetime for
:func:`.memory.memory_table`'s liveness sweep.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "OP_CLASSES", "op_class", "hlo_op_class", "kernel_op_class",
    "Recording", "record", "collectives_table", "op_table",
    "format_op_table",
]

OP_CLASSES = ("blas", "conv", "reduction", "collective", "memory",
              "pointwise", "other")

# --- HLO opcodes (the JAX package's classes, kept for the traces it
# writes: the timeline reads HLO-named device lanes by these) ---------------
_HLO_COLLECTIVE = frozenset((
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all", "collective-broadcast", "send", "recv"))
_HLO_MEMORY = frozenset((
    "copy", "transpose", "broadcast", "reshape", "slice", "concatenate",
    "pad", "reverse", "gather", "scatter", "dynamic-slice",
    "dynamic-update-slice", "iota", "convert", "copy-start", "copy-done"))
_HLO_REDUCTION = frozenset(("reduce", "reduce-window",
                            "select-and-scatter"))
_HLO_OTHER = frozenset((
    "custom-call", "rng", "rng-bit-generator", "sort", "while",
    "conditional", "call", "infeed", "outfeed", "fft", "triangular-solve",
    "cholesky"))


def hlo_op_class(opcode: str) -> str:
    """Bin one HLO opcode into its op class, as the JAX package's
    ``attrib.op_class`` does."""
    if opcode == "dot":
        return "blas"
    if opcode == "convolution":
        return "conv"
    if opcode in _HLO_REDUCTION:
        return "reduction"
    if opcode in _HLO_COLLECTIVE:
        return "collective"
    if opcode in _HLO_MEMORY:
        return "memory"
    if opcode in _HLO_OTHER:
        return "other"
    return "pointwise"


# --- aten ops ---------------------------------------------------------------
_ATEN_BLAS = frozenset((
    "mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "vdot", "mv", "addmv",
    "addbmm", "linear", "_scaled_mm", "_int_mm", "addr", "outer",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_cudnn_attention_backward",
    "_flash_attention_forward", "_flash_attention_backward",
    "_efficient_attention_forward", "_efficient_attention_backward"))
_ATEN_CONV = frozenset((
    "convolution", "_convolution", "convolution_backward",
    "convolution_overrideable", "cudnn_convolution",
    "cudnn_convolution_transpose", "_slow_conv2d_forward",
    "_slow_conv2d_backward", "conv2d", "conv1d", "conv3d",
    "conv_transpose2d", "mkldnn_convolution"))
#: reductions, and the fused ops built around one (softmax, the norms,
#: the losses), as the JAX package bins a fusion holding a reduce
_ATEN_REDUCTION = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "logsumexp", "argmax", "argmin", "all", "any", "cumsum", "cumprod",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_layer_norm",
    "native_layer_norm_backward", "native_batch_norm",
    "native_batch_norm_backward", "_native_batch_norm_legit",
    "_native_batch_norm_legit_no_training", "cudnn_batch_norm",
    "cudnn_batch_norm_backward", "native_group_norm",
    "native_group_norm_backward", "nll_loss_forward",
    "nll_loss_backward", "nll_loss2d_forward", "nll_loss2d_backward",
    "_foreach_norm", "count_nonzero", "aminmax", "nansum"))
#: ops that allocate, view or move data and compute nothing
_ATEN_MEMORY = frozenset((
    "copy", "_to_copy", "clone", "t", "transpose", "permute", "view",
    "_unsafe_view", "reshape", "_reshape_alias", "expand", "slice",
    "select", "cat", "stack", "index", "index_select", "gather",
    "scatter", "scatter_add", "index_put", "index_add", "index_copy",
    "_index_put_impl", "constant_pad_nd", "pad", "flip", "roll",
    "repeat", "narrow", "unsqueeze", "squeeze", "as_strided",
    "contiguous", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
    "fill", "zero", "arange", "split", "split_with_sizes", "chunk",
    "unbind", "embedding", "embedding_dense_backward", "masked_select",
    "take", "unfold", "diagonal", "view_as_real", "view_as_complex",
    "_unsafe_index", "_unsafe_index_put", "select_backward",
    "slice_backward", "index_select_backward", "unsqueeze_copy",
    "_foreach_copy", "set", "resize", "scalar_tensor", "_pin_memory",
    "_copy_from", "_copy_from_and_resize", "slice_scatter",
    "select_scatter", "as_strided_scatter"))
#: views and allocations: no data moves, no bytes counted
_ATEN_NO_TRAFFIC = frozenset((
    "t", "transpose", "permute", "view", "_unsafe_view", "_reshape_alias",
    "expand", "slice", "select", "unsqueeze", "squeeze", "as_strided",
    "detach", "alias", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "split", "split_with_sizes",
    "chunk", "unbind", "narrow", "diagonal", "view_as_real",
    "view_as_complex", "unfold", "lift_fresh", "set", "resize"))
_ATEN_OTHER = frozenset((
    "normal", "uniform", "bernoulli", "rand", "randn", "randint",
    "randperm", "random", "native_dropout", "native_dropout_backward",
    "multinomial", "exponential", "sort", "topk", "nonzero", "unique",
    "_unique2", "_local_scalar_dense", "item", "searchsorted",
    "_fused_dropout", "kthvalue", "median", "mode"))
_TRANSCENDENTAL = frozenset((
    "tanh", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "tan", "atan",
    "atan2", "erf", "erfc", "erfinv", "gelu", "silu", "softplus",
    "reciprocal", "tanh_backward", "sigmoid_backward", "gelu_backward",
    "silu_backward", "logit"))


def _kernel_names() -> frozenset:
    from ..utils.build import KERNEL_FUNCTIONS
    return frozenset(KERNEL_FUNCTIONS)


def _base(name: str) -> str:
    """``aten.add_.Tensor`` / ``aten::add_`` / ``add_`` -> ``add``."""
    name = name.replace("::", ".")
    if name.startswith("aten."):
        name = name[len("aten."):]
    name = name.split(".")[0]
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def op_class(name: str) -> str:
    """Bin one op into its :data:`OP_CLASSES` class.  ``name`` is an aten
    op (``mm``, ``aten.addmm.default``, ``aten::copy_``), a collective
    (``c10d.allreduce_``, ``_c10d_functional.all_gather_into_tensor``) or
    a hand kernel's launch name (``flash_fwd``, binned ``other`` as the
    JAX package bins the Pallas ``custom-call``)."""
    if name in _kernel_names():
        return "other"
    ns = name.replace("::", ".").split(".")[0]
    if ns in ("c10d", "_c10d_functional", "c10d_functional"):
        return "collective"
    base = _base(name)
    if base in _ATEN_BLAS:
        return "blas"
    if base in _ATEN_CONV:
        return "conv"
    if base in _ATEN_REDUCTION:
        return "reduction"
    if base in _ATEN_MEMORY:
        return "memory"
    if base in _ATEN_OTHER:
        return "other"
    return "pointwise"


# --- CUDA kernels, by the names a profiler lists ----------------------------
_K_COLLECTIVE = ("nccl",)
_K_NORM = ("bn_fw", "bn_bw", "batch_norm", "batchnorm", "layer_norm",
           "layernorm", "group_norm")
_K_CONV = ("fprop", "dgrad", "wgrad", "conv", "winograd", "implicit_convolve",
           "cudnn")
_K_BLAS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "gemv",
           "splitkreduce", "gemmk1", "matmul")
_K_REDUCTION = ("reduce_kernel", "reduction", "softmax", "norm_kernel",
                "nll_loss", "cross_entropy", "radixsort", "scan")
_K_MEMORY = ("copy_kernel", "catarraybatchedcopy", "index", "gather",
             "scatter", "fillfunctor", "transpose", "permute")


def kernel_op_class(name: str, cat: Optional[str] = "kernel") -> str:
    """Bin one CUDA kernel of a profiler trace into its op class: NCCL
    collective; the port's own kernels other; cuDNN convolutions conv;
    cuBLAS / cuBLASLt (``nvjet_*``, ``sm90_xmma_*``) and CUTLASS GEMMs
    blas; reductions, softmax and norms reduction; copies, fills, gathers
    and ``gpu_memcpy`` / ``gpu_memset`` memory; the rest pointwise."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memory"
    n = name.lower()
    if n.startswith(("memcpy", "memset")):
        return "memory"
    if any(k in n for k in _K_COLLECTIVE):
        return "collective"
    from ..utils.build import is_port_kernel
    if is_port_kernel(name):
        return "other"
    if any(k in n for k in _K_NORM):
        return "reduction"
    if any(k in n for k in _K_CONV):
        return "conv"
    if any(k in n for k in _K_BLAS):
        return "blas"
    if any(k in n for k in _K_REDUCTION):
        return "reduction"
    if any(k in n for k in _K_MEMORY):
        return "memory"
    return "pointwise"


# ---------------------------------------------------------------------------
# the recording
# ---------------------------------------------------------------------------

#: metadata queries: no row (FlopCounterMode passes them by too)
_META_OPS = frozenset(("is_contiguous", "sym_is_contiguous",
                       "is_strides_like_format",
                       "is_non_overlapping_and_dense", "size", "sym_size",
                       "stride", "sym_stride", "storage_offset",
                       "sym_storage_offset", "numel", "sym_numel", "dim",
                       "layout", "device"))


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, dict):
            stack.extend(t.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def keyed_tensors(tree, prefix: str):
    """``(keypath, tensor)`` for every tensor in ``tree`` (dataclasses,
    dicts, lists, tuples), keypaths in the JAX style
    (``state.opt_state.master``, ``batch['tokens']``)."""
    out = []
    seen = set()

    def walk(t, path):
        if isinstance(t, torch.Tensor):
            out.append((path, t))
            return
        if id(t) in seen:
            return
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            seen.add(id(t))
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name, None), f"{path}.{f.name}")
        elif isinstance(t, dict):
            seen.add(id(t))
            for k in sorted(t, key=str):
                walk(t[k], f"{path}['{k}']")
        elif isinstance(t, (list, tuple)):
            seen.add(id(t))
            fields = getattr(t, "_fields", None)
            for i, v in enumerate(t):
                walk(v, f"{path}.{fields[i]}" if fields else f"{path}[{i}]")

    walk(tree, prefix)
    return out


def _arg_names(fn, args, kwargs) -> List[tuple]:
    """``(name, value)`` of each argument: the signature's names where
    the signature binds, else ``args[i]`` / the keyword."""
    try:
        bound = inspect.signature(fn).bind(*args, **kwargs)
        return list(bound.arguments.items())
    except (TypeError, ValueError):
        return ([(f"args[{i}]", a) for i, a in enumerate(args)]
                + list(kwargs.items()))


class Recording(TorchDispatchMode):
    """Records one row per dispatched op and per reported kernel launch
    (``rows``, in dispatch order) and, with ``liveness``, the lifetime of
    every storage the call touches (``buffers``: ``{key, bytes, device,
    start, end, opcode, op, cls}``; ``start`` / ``end`` are row indices,
    ``end`` None while the storage lives).  A storage is tracked through
    a ``StorageWeakRef``: autograd keeps saved tensors alive in C++ after
    their Python objects are gone, so the storage, not the tensor, is what
    lives; each row polls the open storages first, and one found expired
    there died after the row before.  Thread-safe: autograd's backward
    threads report under a lock.  With ``allocator`` (a CUDA device) each
    row also reads the caching allocator's live bytes after it
    (``allocated``: ``torch.cuda.memory_allocated``, a host-side counter,
    no sync), the allocator's own curve beside the sweep's."""

    def __init__(self, *, liveness: bool = False, allocator=None):
        super().__init__()
        self.rows: List[dict] = []
        self.liveness = bool(liveness)
        self.allocator = allocator
        self.allocated: List[int] = []
        self.buffers: List[dict] = []
        self._open: Dict[int, tuple] = {}   # storage key -> (ref, buffer)
        self._fixed: Dict[int, dict] = {}   # caller-held storages
        self._lock = threading.Lock()

    # -- storages -----------------------------------------------------------
    def _storage(self, t: torch.Tensor):
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None
        from torch.multiprocessing.reductions import StorageWeakRef
        ref = StorageWeakRef(s)
        return ref.cdata, ref, s.nbytes(), t.device

    def _poll(self) -> None:
        i = len(self.rows)
        dead = [k for k, (ref, _) in self._open.items() if ref.expired()]
        for k in dead:
            _, buf = self._open.pop(k)
            buf["end"] = max(buf["start"], i - 1)

    def track(self, tensors, *, start: int, cls: Optional[str] = None,
              opcode: str = "", op: str = "", fixed: bool = False) -> None:
        """Open a buffer for each storage of ``tensors`` not tracked yet
        (a view or an in-place op's output is its input's storage)."""
        for t in tensors:
            got = self._storage(t)
            if got is None:
                continue
            key, ref, nbytes, device = got
            if key in self._open or key in self._fixed:
                continue
            buf = {"key": key, "bytes": int(nbytes), "device": device,
                   "start": start, "end": None, "opcode": opcode, "op": op,
                   "cls": cls}
            self.buffers.append(buf)
            if fixed:
                self._fixed[key] = buf
            else:
                self._open[key] = (ref, buf)

    def finish(self, outputs) -> None:
        """Close the sweep after the call: storages that died after the
        last row end there; the result's own storages are ``output``."""
        with self._lock:
            self._poll()
            last = max(len(self.rows) - 1, 0)
            for t in outputs:
                got = self._storage(t)
                if got is None:
                    continue
                key = got[0]
                if key in self._open:
                    self._open[key][1]["is_output"] = True
            for _, buf in self._open.values():
                buf["end"] = last
            for buf in self._fixed.values():
                buf["end"] = last
            self._open.clear()

    # -- rows ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet.__name__ in _META_OPS:
            return func(*args, **kwargs)
        from torch.utils.flop_counter import flop_registry
        if func is not torch.ops.prim.device.default:
            # as FlopCounterMode does: an op with a decomposition runs as
            # its parts, each of which takes its own row
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if self.liveness:
            with self._lock:
                self._poll()
        out = func(*args, **kwargs)
        ns = getattr(func, "namespace", "aten")
        name = packet.__name__ if ns == "aten" else f"{ns}.{packet.__name__}"
        cls = op_class(name)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        base = _base(name)
        if base in _ATEN_NO_TRAFFIC:
            in_b = out_b = 0
        else:
            in_b = sum(_nbytes(t) for t in ins)
            out_b = sum(_nbytes(t) for t in outs)
        out_elems = sum(t.numel() for t in outs)
        trans = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        elif cls == "pointwise":
            flops = float(out_elems)
            if base in _TRANSCENDENTAL:
                trans = float(out_elems)
        elif cls == "reduction":
            flops = float(ins[0].numel()) if ins else float(out_elems)
        else:
            flops = 0.0
        with self._lock:
            i = len(self.rows)
            self.rows.append({
                "op": f"{name}.{i}", "opcode": name, "class": cls,
                "jax_op": str(func), "flops": flops,
                "transcendentals": trans, "bytes": float(in_b + out_b),
                "out_bytes": float(out_b)})
            if self.liveness:
                self.track(outs, start=i, opcode=name, op=f"{name}.{i}")
            self._read_allocator()
        return out

    def _read_allocator(self) -> None:
        if self.allocator is not None:
            self.allocated.append(torch.cuda.memory_allocated(self.allocator))

    def note_kernel(self, name: str, tensors) -> None:
        """One hand-kernel launch (reported by ``build.launched``)."""
        with self._lock:
            if self.liveness:
                self._poll()
            i = len(self.rows)
            self.rows.append({
                "op": f"{name}.{i}", "opcode": name, "class": "other",
                "jax_op": f"kernel:{name}", "flops": 0.0,
                "transcendentals": 0.0,
                "bytes": float(sum(_nbytes(t) for t in tensors)),
                "out_bytes": 0.0})
            self._read_allocator()


def record(fn: Callable, *args, liveness: bool = False, allocator=None,
           **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`Recording`;
    returns ``(result, recording)``.  With ``liveness`` the caller's
    argument storages are tracked from row 0 to the end, each classed by
    its keypath."""
    from ..utils import build
    rec = Recording(liveness=liveness, allocator=allocator)
    if liveness:
        from .memory import classify_arg
        for aname, value in _arg_names(fn, args, kwargs):
            for path, t in keyed_tensors(value, aname):
                rec.track([t], start=0, cls=classify_arg(path),
                          opcode="parameter", op=path, fixed=True)
    build.open_recording()
    try:
        with rec:
            result = fn(*args, **kwargs)
    finally:
        build.close_recording()
    if liveness:
        rec.finish([t for _, t in keyed_tensors(result, "out")])
    return result, rec


def _device_of_args(args, kwargs) -> torch.device:
    """The device of the call's first tensor argument (the CPU without
    one)."""
    for _, t in keyed_tensors((list(args), kwargs), "a"):
        return t.device
    return torch.device("cpu")


def collectives_table(rows) -> dict:
    """Per-collective logical-byte sub-table from the rows of class
    ``collective``: ``logical_bytes`` per op is ``max(in, out)``, the full
    logical payload whichever side holds it."""
    out_rows = []
    by_opcode: Dict[str, dict] = {}
    for r in rows:
        if r["class"] != "collective":
            continue
        in_bytes = max(0.0, r["bytes"] - r["out_bytes"])
        logical = max(in_bytes, r["out_bytes"])
        out_rows.append({
            "op": r["op"], "opcode": r["opcode"], "jax_op": r["jax_op"],
            "in_bytes": in_bytes, "out_bytes": r["out_bytes"],
            "logical_bytes": logical,
        })
        agg = by_opcode.setdefault(
            r["opcode"], {"count": 0, "in_bytes": 0.0, "out_bytes": 0.0,
                          "logical_bytes": 0.0})
        agg["count"] += 1
        agg["in_bytes"] += in_bytes
        agg["out_bytes"] += r["out_bytes"]
        agg["logical_bytes"] += logical
    return {
        "rows": out_rows,
        "by_opcode": by_opcode,
        "total_logical_bytes": sum(r["logical_bytes"] for r in out_rows),
    }


def table_from_rows(rows: List[dict], platform: str, peak_flops: float,
                    peak_bw: float) -> dict:
    """The JAX ``op_table`` document over recorded rows: per-row
    intensity / roofline projection / shares, per-opcode and per-class
    rollups, the collectives sub-table and the totals."""
    total_flops = sum(r["flops"] for r in rows)
    total_bytes = sum(r["bytes"] for r in rows)
    by_opcode: Dict[str, dict] = {}
    by_class: Dict[str, dict] = {}
    for r in rows:
        r["intensity"] = r["flops"] / r["bytes"] if r["bytes"] else 0.0
        r["projected_us"] = 1e6 * max(r["flops"] / peak_flops,
                                      r["bytes"] / peak_bw)
        r["pct_flops"] = 100.0 * r["flops"] / total_flops if total_flops \
            else 0.0
        r["pct_bytes"] = 100.0 * r["bytes"] / total_bytes if total_bytes \
            else 0.0
        for key, table in ((r["opcode"], by_opcode), (r["class"], by_class)):
            agg = table.setdefault(key, {"count": 0, "flops": 0.0,
                                         "bytes": 0.0})
            agg["count"] += 1
            agg["flops"] += r["flops"]
            agg["bytes"] += r["bytes"]
    for c in by_class.values():
        c["pct_flops"] = 100.0 * c["flops"] / total_flops if total_flops \
            else 0.0
        c["pct_bytes"] = 100.0 * c["bytes"] / total_bytes if total_bytes \
            else 0.0
    rows.sort(key=lambda r: (r["flops"], r["bytes"]), reverse=True)
    return {
        "platform": platform,
        "rows": rows,
        "collectives": collectives_table(rows),
        "by_opcode": by_opcode,
        "by_class": by_class,
        "total_flops": total_flops,
        "total_bytes": total_bytes,
        "module_flops": None,
        "module_bytes": None,
        "peak_flops": peak_flops,
        "peak_bw": peak_bw,
    }


def op_table(fn: Callable, *args, peak_flops: Optional[float] = None,
             peak_bw: Optional[float] = None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Recording` and
    return the per-op cost attribution: ``{platform, rows, collectives,
    by_opcode, by_class, total_flops, total_bytes, module_flops,
    module_bytes, peak_flops, peak_bw}``, each row carrying ``op``,
    ``opcode``, ``class``, ``jax_op``, ``flops``, ``transcendentals``,
    ``bytes``, ``out_bytes``, ``intensity`` (FLOP/B), ``projected_us``
    (its roofline lower bound) and ``pct_flops`` / ``pct_bytes``."""
    from ..pyprof.prof import platform_of, resolve_ceilings
    platform = platform_of(_device_of_args(args, kwargs))
    ceil = resolve_ceilings(platform)
    _, rec = record(fn, *args, **kwargs)
    return table_from_rows(rec.rows, platform,
                           peak_flops or ceil["peak_flops"],
                           peak_bw or ceil["peak_bw"])


def _human(n: Optional[float], unit: str = "") -> str:
    from ..pyprof.prof import _human as h
    return "n/a" if n is None else h(n, unit)


def format_op_table(table: dict, top: int = 20) -> str:
    """One sorted row per op (FLOPs / bytes / intensity / roofline
    columns), the collectives sub-table and the per-class rollup."""
    rows = table["rows"]
    shown = rows[:top]
    lines = [
        f"per-op cost attribution ({table['platform']}; "
        f"{len(rows)} ops, top {len(shown)} by FLOPs)",
        f"{'op':<34} {'opcode':<14} {'flops':>10} {'bytes':>10} "
        f"{'FLOP/B':>8} {'proj us':>9} {'%flops':>7}",
    ]
    for r in shown:
        name = r["op"]
        if len(name) > 33:
            name = name[:30] + "..."
        opcode = r["opcode"] if len(r["opcode"]) <= 14 \
            else r["opcode"][:11] + "..."
        lines.append(
            f"{name:<34} {opcode:<14} "
            f"{_human(r['flops']):>10} {_human(r['bytes']):>10} "
            f"{r['intensity']:>8.1f} {r['projected_us']:>9.2f} "
            f"{r['pct_flops']:>6.1f}%")
    if len(rows) > top:
        rest_f = sum(r["flops"] for r in rows[top:])
        rest_b = sum(r["bytes"] for r in rows[top:])
        lines.append(f"{'... ' + str(len(rows) - top) + ' more ops':<49} "
                     f"{_human(rest_f):>10} {_human(rest_b):>10}")
    coll = table.get("collectives") or {}
    if coll.get("rows"):
        lines.append("per-collective logical bytes")
        for opcode, agg in sorted(coll["by_opcode"].items()):
            lines.append(
                f"  {opcode:<32} {agg['count']:>4} ops   "
                f"in {_human(agg['in_bytes'], 'B'):>10} "
                f"out {_human(agg['out_bytes'], 'B'):>10} "
                f"logical {_human(agg['logical_bytes'], 'B'):>10}")
    by_class = table.get("by_class") or {}
    if by_class:
        lines.append("per-class rollup (pyprof prof/ vocabulary)")
        for cls in OP_CLASSES:
            agg = by_class.get(cls)
            if agg is None:
                continue
            lines.append(
                f"  {cls:<32} {agg['count']:>4} ops   "
                f"{_human(agg['flops']):>10} {_human(agg['bytes']):>10} "
                f"{agg['pct_flops']:>6.1f}% {agg['pct_bytes']:>6.1f}%")
    lines.append(
        f"recorded totals     {_human(table['total_flops'], 'FLOP')} / "
        f"{_human(table['total_bytes'], 'B')}  (no compiler cost model: "
        "one run, dispatched ops and kernel launches)")
    lines.append(
        f"roofline ceilings   {_human(table['peak_flops'], 'FLOP/s')}, "
        f"{_human(table['peak_bw'], 'B/s')}")
    return "\n".join(lines)
