"""Build and load the port's CUDA kernels.

The sources under ``apex_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled for Hopper (``sm_90a``) with ``nvcc``, one
process per source, all started together, and linked into one shared
library that is loaded with ``ctypes``.  The library lands in
``build/apex_tpu_torch/<hash>/`` beside the package, where the hash covers
the sources and the flags, so an edited source builds anew and an unchanged
one is loaded as it is.

The host code, ``csrc/prefetch.cpp`` (the data loader's prefetch ring) and
``csrc/host_pack.cpp`` (the threaded host packing of
:mod:`apex_tpu_torch.utils.host_pack`), has no kernel: each file is built
apart, with the host C++ compiler and no ``nvcc``, into
``build/apex_tpu_torch/host/<hash>/`` at first use (:func:`build_host`,
:func:`host_library`, :func:`host_pack_library`), so a host without the
CUDA toolkit builds it too.  Neither is among the ``nvcc`` sources or in
their hash.

Each wrapper passes ``data_ptr()``s, sizes and the current stream; each C
entry point returns ``cudaGetLastError()``, which :func:`check` turns into
an exception.  ``LAUNCHES`` counts kernel launches by name (``flash_fwd``,
``flash_bwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``, ``ln_fwd``,
``ln_bwd``, ``xent_fwd``, ``l2norm``, ``adam``, ``lamb_stage1``,
``mt_scale``, ``mt_axpby``, ``dense_act``): a wrapper adds one where it
launches its kernel and nowhere else, through :func:`launched`, which also
reports the launch to a recording open in the calling thread
(``telemetry.attrib.op_table``, ``telemetry.memory.memory_table``).
:data:`KERNEL_FUNCTIONS` names the CUDA functions behind each launch name,
as a profiler lists them (:func:`launch_name`).  :func:`dtype_code` gives a
dtype's C code; every kernel has an fp32, a bf16 and an fp16 branch
(:data:`FLOATS`), and any other dtype is refused with a ``TypeError``
before any launch.  Headers
(``csrc/*.cuh``) are not compiled on their own but count in the hash.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import re
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import torch

__all__ = ["LAUNCHES", "BuildResult", "build", "load", "library", "check",
           "dtype_code", "stream_of", "NVCC_FLAGS", "FLOATS", "HOST_FLAGS",
           "build_host", "host_library", "host_pack_library", "launched",
           "KERNEL_FUNCTIONS",
           "AUX_FUNCTIONS", "launch_name", "is_port_kernel"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "apex_tpu_torch"
LIB_NAME = "libapex_tpu_torch.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches by kernel name, counted by the wrappers
LAUNCHES: collections.Counter = collections.Counter()

#: the CUDA functions a launch of each name runs, as a profiler lists them:
#: (function names, {template argument index: value}); the template argument
#: tells apart two launch names that share a function (flash_bwd's fused
#: kernel emits dq, flash_bwd_dkv's does not; flat_update_kernel<kLamb, ..>;
#: scale_axpby_kernel<.., kAxpby>).  Each launch runs exactly one of its
#: name's functions, apart from l2norm's second, :data:`AUX_FUNCTIONS`.
_FLASH_KV = ("flash_bwd_kv_sm90_kernel", "flash_bwd_kv_tf32_kernel",
             "flash_bwd_simt_kernel", "flash_bwd_chunk_kernel")
KERNEL_FUNCTIONS = {
    "flash_fwd": (("flash_fwd_sm90_kernel", "flash_fwd_tf32_kernel",
                   "flash_fwd_simt_kernel", "flash_fwd_chunk_kernel"), {}),
    "flash_bwd": (_FLASH_KV, {-1: "true"}),
    "flash_bwd_dkv": (_FLASH_KV, {-1: "false"}),
    "flash_bwd_dq": (("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_simt_kernel",
                      "flash_bwd_dq_chunk_kernel"), {}),
    "ln_fwd": (("ln_fwd_kernel", "ln_fwd_wide_kernel"), {}),
    "ln_bwd": (("ln_bwd_kernel", "ln_bwd_wide_kernel"), {}),
    "xent_fwd": (("xent_warp_kernel", "xent_wide_kernel"), {}),
    "l2norm": (("sumsq_partials_kernel",), {}),
    "adam": (("flat_update_kernel",), {0: "false"}),
    "lamb_stage1": (("flat_update_kernel",), {0: "true"}),
    "mt_scale": (("scale_axpby_kernel",), {-1: "false"}),
    "mt_axpby": (("scale_axpby_kernel",), {-1: "true"}),
    "dense_act": (("dense_act_sm90_kernel", "dense_act_mma_kernel",
                   "dense_act_f32_kernel"), {}),
}
#: the port's CUDA functions that run beside a counted one
AUX_FUNCTIONS = ("finish_kernel",)
_FUNC_RE = re.compile(r"\b(\w+_kernel)\b\s*(<)?")


def _template_args(kernel: str, start: int) -> List[str]:
    """The top-level template arguments of the demangled name ``kernel``
    whose ``<`` is at ``start``."""
    depth, args, cur = 0, [], ""
    for ch in kernel[start:]:
        if ch == "<":
            depth += 1
            if depth == 1:
                continue
        elif ch == ">":
            depth -= 1
            if depth == 0:
                args.append(cur.strip())
                break
        elif ch == "," and depth == 1:
            args.append(cur.strip())
            cur = ""
            continue
        cur += ch
    return args


def launch_name(kernel: str) -> Optional[str]:
    """The launch name (a key of ``LAUNCHES``) whose wrapper runs the CUDA
    function a profiler lists as ``kernel`` (its demangled name), else
    None: a library's kernel, or :data:`AUX_FUNCTIONS`."""
    for m in _FUNC_RE.finditer(kernel):
        func = m.group(1)
        args = _template_args(kernel, m.start(2)) if m.group(2) else []
        for name, (funcs, flags) in KERNEL_FUNCTIONS.items():
            if func in funcs and all(
                    -len(args) <= i < len(args) and args[i] == v
                    for i, v in flags.items()):
                return name
    return None


def is_port_kernel(kernel: str) -> bool:
    """Does the profiler's ``kernel`` name one of the port's functions?"""
    if launch_name(kernel) is not None:
        return True
    return any(m.group(1) in AUX_FUNCTIONS
               for m in _FUNC_RE.finditer(kernel))


#: open launch recordings in any thread; 0 keeps :func:`launched` to one
#: counter bump
_recordings = 0


def open_recording() -> None:
    global _recordings
    _recordings += 1


def close_recording() -> None:
    global _recordings
    _recordings -= 1


def launched(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Count one launch of ``name`` in ``LAUNCHES``, and report it to every
    recording on this thread's dispatch-mode stack (a recording's mode
    object with a ``note_kernel(name, tensors)`` method).  ``tensors`` are
    the operands the kernel reads and the outputs it writes (None skipped).
    The dispatch-mode stack is thread-local, and autograd carries it into
    the threads that run a backward, so a kernel launched from a backward
    reports to the recording that the forward ran under."""
    LAUNCHES[name] += 1
    if not _recordings:
        return
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    live = [t for t in tensors if t is not None]
    for mode in _get_current_dispatch_mode_stack():
        note = getattr(mode, "note_kernel", None)
        if note is not None:
            note(name, live)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the floating types the kernels take: each has an fp32, a bf16 and an
#: fp16 branch, as the JAX package's kernels compute at any float type
FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # x, w, b, out, mean, invvar, n_rows, h, eps, x_dtype, w_dtype, path,
    # vec, stream
    "apex_ln_fwd": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _I, _I,
                    _VP],
    # g, x, mean, invvar, w, dx, n_rows, h, x_dtype, w_dtype, path, vec,
    # stream
    "apex_ln_bwd": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                    _VP],
    # q, k, v, bias, out, lse, stats, bh, sq, sk, d, heads, bias_b, bias_q,
    # causal, drop_threshold, keep_div, seed, dtype, stream
    "apex_flash_fwd": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                       _I, _I, _I, _U, _F, _I, _I, _VP],
    # q, k, v, bias, dout, stats, delta, dq_part, dk, dv, bh, sq, sk, d,
    # heads, bias_b, bias_q, causal, drop_threshold, keep_div, seed, dtype,
    # stream
    "apex_flash_bwd": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _I, _I, _I, _I, _I, _I, _I, _I, _U, _F, _I, _I, _VP],
    # q, k, v, bias, dout, stats, delta, dq, bh, sq, sk, d, heads, bias_b,
    # bias_q, causal, drop_threshold, keep_div, seed, dtype, stream
    "apex_flash_bwd_dq": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _I, _I, _I, _I, _I, _I, _I, _I, _U, _F, _I, _I,
                          _VP],
    # q, k, v, bias, dout, stats, delta, dk, dv, then as apex_flash_bwd_dq
    "apex_flash_bwd_dkv": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _I, _I, _I, _I, _I, _I, _I, _I, _U, _F, _I, _I,
                           _VP],
    # logits, labels, loss, lse, n, v, smoothing, dtype, path, stream
    "apex_xent_fwd": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _VP],
    # x, n, partials, n_blocks, out, dtype, stream
    "apex_l2norm": [_VP, _LL, _VP, _I, _VP, _I, _VP],
    # g, p, m, v, scalars, p_out, m_out, v_out, copy, n, n_blocks, adam_w,
    # copy_dtype, stream
    "apex_fused_adam": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL,
                        _I, _I, _I, _VP],
    # g, p, m, v, scalars, u, m_out, v_out, n, n_blocks, adam_w, stream
    "apex_lamb_stage1": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _I,
                         _I, _VP],
    # x, y, a_ptr, a, b_ptr, b, out, flag, n, n_blocks, in_dtype, out_dtype,
    # stream (y and the b pair null / unused for the scale)
    "apex_mt_scale_axpby": [_VP, _VP, _VP, _F, _VP, _F, _VP, _VP, _LL, _I,
                            _I, _I, _VP],
    # x, w, b, out, m, n, k, activation, dtype, stream
    "apex_dense_act": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    "apex_dense_act_sm90": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
}


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float
    cached: bool
    log: str          # compiler output (ptxas register / spill report)


def sources(csrc: Path = CSRC) -> List[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(srcs: List[Path], csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs + list(csrc.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build(csrc: Path = CSRC) -> BuildResult:
    """Compile the kernels of ``csrc`` (the package's sources, or an edited
    copy of them) unless a library for these sources exists."""
    srcs = sources(csrc)
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    out_dir = BUILD_ROOT / _digest(srcs, csrc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return BuildResult(lib, 0.0, True, "")
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    return BuildResult(lib, time.perf_counter() - t0, False, "\n".join(logs))


_LIB: Optional[ctypes.CDLL] = None


def load(path: Path) -> ctypes.CDLL:
    """A built library with its entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.apex_error_string.argtypes = [ctypes.c_int]
    lib.apex_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        _LIB = load(build().path)
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().apex_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({msg})")


def dtype_code(dtype: torch.dtype, what: str = "the kernel") -> int:
    """The C code of ``dtype``; ``TypeError`` unless it is one of
    :data:`FLOATS`, the dtypes every kernel has a branch for."""
    if dtype not in FLOATS:
        names = "/".join(str(d).replace("torch.", "") for d in FLOATS)
        raise TypeError(f"{what} takes {names}, got {dtype}")
    return _DTYPE_CODES[dtype]


# ---------------------------------------------------------------------------
# host code: the prefetch ring and the host packing
# ---------------------------------------------------------------------------

HOST_SOURCE = CSRC / "prefetch.cpp"
HOST_PACK_SOURCE = CSRC / "host_pack.cpp"
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

#: the loaded host libraries by source (None: it could not be built)
_HOST_LIBS: dict = {}


def _host_cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler ($CXX, g++ or c++ on PATH): "
                       "the host code cannot be built")


def build_host(src: Path = HOST_SOURCE) -> BuildResult:
    """Compile the host source ``src`` with the host C++ compiler into a
    shared library, ``libapex_tpu_torch_<stem>.so``, unless one for this
    source and these flags exists."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / "host" / h.hexdigest()[:16]
    name = f"libapex_tpu_torch_{src.stem}.so"
    lib = out_dir / name
    if lib.exists():
        return BuildResult(lib, 0.0, True, "")
    cxx = _host_cxx()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {src.name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return BuildResult(lib, time.perf_counter() - t0, False, proc.stdout)


def _host_lib(src: Path, signatures) -> Optional[ctypes.CDLL]:
    """The library of host source ``src``, built at first use, with
    ``signatures(lib)`` applied; None where it cannot be built or loaded
    (no host compiler), remembered for the process."""
    if src not in _HOST_LIBS:
        try:
            lib = ctypes.CDLL(str(build_host(src).path))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            lib = None
        if lib is not None and not signatures(lib):
            lib = None
        _HOST_LIBS[src] = lib
    return _HOST_LIBS[src]


def _prefetch_signatures(lib) -> bool:
    lib.pf_create.restype = ctypes.c_void_p
    lib.pf_create.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint64]
    lib.pf_acquire.restype = ctypes.c_int32
    lib.pf_acquire.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
    lib.pf_release.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pf_destroy.argtypes = [ctypes.c_void_p]
    return True


def _host_pack_signatures(lib) -> bool:
    i64p = ctypes.POINTER(ctypes.c_int64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.apex_torch_host_pack.argtypes = [
        vpp, i64p, i64p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.apex_torch_host_pack.restype = None
    lib.apex_torch_host_unpack.argtypes = [
        ctypes.c_void_p, i64p, i64p, ctypes.c_int64, vpp, ctypes.c_int64]
    lib.apex_torch_host_unpack.restype = None
    lib.apex_torch_host_pack_abi.restype = ctypes.c_int
    return lib.apex_torch_host_pack_abi() == 1


def host_library() -> Optional[ctypes.CDLL]:
    """The prefetch ring's library (``csrc/prefetch.cpp``), or None where
    it cannot be built (the loader reports it through
    ``native_available``)."""
    return _host_lib(HOST_SOURCE, _prefetch_signatures)


def host_pack_library() -> Optional[ctypes.CDLL]:
    """The host packing library (``csrc/host_pack.cpp``), or None where it
    cannot be built (the callers take numpy)."""
    return _host_lib(HOST_PACK_SOURCE, _host_pack_signatures)


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
