"""The measured-tuning profile's reader: ``tuned_defaults.json``.

Counterpart of ``apex_tpu/utils/tuning.py``: one JSON dict of measured
winners (kernel block sizes, routes, the DDP collective scheme and update
sharding, the auto-parallel plan's ``plan_*`` keys, the planner's overlap
fractions, serving defaults), the keys and value rules of the JAX
package's :data:`SCHEMA`, so one profile validates the same under both
packages.

Precedence everywhere: explicit argument > environment override > tuning
profile > built-in default.  With no profile on disk nothing changes.

Readers: :func:`get` for values that do not depend on the device (the
planner's overlap fractions, tooling); :func:`get_on_gpu` for runtime
defaults, which apply a measured winner only where it was measured, on
the card.  The runtime knobs that read it, each after its explicit
argument and its environment override: ``flash._resolve_backward``
(``flash_bwd_impl``) and ``_resolve_fuse`` (``flash_bwd_fuse``), the
cross-entropy's ``impl="auto"`` (``xent_auto_impl``), ``fused_layer_norm``
and ``FusedLayerNorm``'s ``use_pallas=None`` (``layer_norm_use_pallas``),
``MLP(use_pallas=None)`` (``mlp_use_pallas``), ``bert_large_config``
(``bert_attn_impl``), the ZeRO optimizers' ``impl=None`` (``zero_impl``),
``collectives.resolve`` (``ddp_collective_scheme``,
``collective_min_compress_bytes``), ``overlap.resolve_mode``
(``ddp_overlap``), ``weight_update.resolve_mode``
(``ddp_update_sharding``) and the zero1 all-gather
(``ddp_update_allgather_scheme``); ``parallel.plan.from_tuning`` and
``resolve_overlap_fraction`` read the ``plan_*`` / ``overlap_*`` keys.
The flash block keys (``flash_block_*``, ``flash_bwd_*block_*``) size the
JAX package's Pallas blocks against VMEM; the CUDA kernels' tiles are
fixed when they are compiled, so nothing reads them here.
``serve_decode_batch`` / ``serve_olevel`` are read by the JAX bench
harness, not by its package, and get no reader either.

Profile location: ``$APEX_TPU_TUNING_FILE`` if set, else
``apex_tpu_torch/tuned_defaults.json`` next to this package (the
repository ships none).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

__all__ = ["SCHEMA", "schema_violations", "profile_path", "reload", "get",
           "get_on_gpu"]

_is_block = lambda v: isinstance(v, int) and not isinstance(v, bool) \
    and v > 0  # noqa: E731
_is_bool = lambda v: isinstance(v, bool)  # noqa: E731
_is_frac = lambda v: (isinstance(v, (int, float))  # noqa: E731
                      and not isinstance(v, bool) and 0.0 <= v <= 1.0)
_one_of = lambda *names: (lambda v: v in names)  # noqa: E731

#: every key a profile may hold, with the rule its value must meet (the
#: JAX package's schema, key for key); ``_``-prefixed metadata such as
#: ``_provenance`` rides alongside, exempt
SCHEMA = {
    "flash_block_q": _is_block,
    "flash_block_k": _is_block,
    "flash_bwd_block_q": _is_block,
    "flash_bwd_block_k": _is_block,
    "flash_bwd_dq_block_q": _is_block,
    "flash_bwd_dq_block_k": _is_block,
    "flash_bwd_dkv_block_q": _is_block,
    "flash_bwd_dkv_block_k": _is_block,
    "flash_bwd_impl": _one_of("pallas", "xla"),
    "flash_bwd_fuse": _is_bool,
    "xent_auto_impl": _one_of("pallas", "xla"),
    "bert_attn_impl": _one_of("fast", "default"),
    "layer_norm_use_pallas": _is_bool,
    "mlp_use_pallas": _is_bool,
    "zero_impl": _one_of("fused", "xla"),
    # the DDP gradient wire and the byte threshold under which leaves stay
    # fp32
    "ddp_collective_scheme": _one_of("fp32", "bf16", "int8_blockscale",
                                     "adasum"),
    "collective_min_compress_bytes": _is_block,
    # weight-update sharding and its param all-gather wire
    "ddp_update_sharding": _one_of("off", "zero1"),
    "ddp_update_allgather_scheme": _one_of("fp32", "bf16",
                                           "int8_blockscale"),
    # the auto-parallel plan that won a measured A/B
    # (``parallel.plan.from_tuning``; applied only at its chip count)
    "plan_dp": _is_block,
    "plan_tp": _is_block,
    "plan_sp": _is_block,
    "plan_sp_strategy": _one_of("none", "ring", "ulysses"),
    "plan_pp_stages": _is_block,
    "plan_pp_microbatches": _is_block,
    "plan_ep": _is_block,
    "plan_zero": _is_bool,
    "plan_update_sharding": _one_of("off", "zero1"),
    "plan_collective_scheme": _one_of("fp32", "bf16", "int8_blockscale"),
    "plan_allgather_scheme": _one_of("fp32", "bf16", "int8_blockscale"),
    # the measured exposed-comm fraction the planner's comm model charges
    # (1.0 = fully synchronous), globally and per wire scheme
    "overlap_measured_fraction": _is_frac,
    "ddp_overlap": _one_of("off", "bucketed"),
    "overlap_fraction_fp32": _is_frac,
    "overlap_fraction_bf16": _is_frac,
    "overlap_fraction_int8_blockscale": _is_frac,
    # serving defaults
    "serve_decode_batch": _is_block,
    "serve_olevel": _one_of("fp32", "bf16", "int8"),
}


def schema_violations(profile: dict) -> list:
    """Complaints about a profile dict (empty = valid): unknown keys and
    values that break their rule; ``_``-prefixed keys are exempt."""
    out = []
    for k, v in profile.items():
        if k.startswith("_"):
            continue
        if k not in SCHEMA:
            out.append(f"unknown key {k!r}")
        elif not SCHEMA[k](v):
            out.append(f"bad value for {k!r}: {v!r}")
    return out


_cache: Optional[dict] = None
_cache_src: Optional[str] = None


def profile_path() -> str:
    env = os.environ.get("APEX_TPU_TUNING_FILE")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tuned_defaults.json")


def _load() -> dict:
    """The profile at :func:`profile_path`, cached per path; a missing,
    unreadable or non-dict file reads as empty."""
    global _cache, _cache_src
    path = profile_path()
    if _cache is not None and _cache_src == path:
        return _cache
    data: dict = {}
    try:
        with open(path) as f:
            loaded = json.load(f)
        if isinstance(loaded, dict):
            data = loaded
    except (OSError, ValueError):
        pass
    _cache, _cache_src = data, path
    return data


def reload() -> None:
    """Drop the cached profile (after rewriting the file, or in tests)."""
    global _cache, _cache_src
    _cache = None
    _cache_src = None


def get(key: str, default: Any = None) -> Any:
    """Measured value for ``key``, else ``default``."""
    return _load().get(key, default)


def _cuda_initialized() -> bool:
    """Has this process already brought CUDA up?  Never brings it up
    (:func:`apex_tpu_torch.utils.platform.backends_initialized`)."""
    from .platform import backends_initialized
    return backends_initialized()


def get_on_gpu(key: str, default: Any = None) -> Any:
    """Measured value for ``key``, applied ONLY on the card.

    The profile records winners measured on the card; applying them to a
    CPU run would pick routes and layouts the measurements say nothing
    about.  This is the accessor runtime defaults use; :func:`get` is for
    device-independent values and tooling.

    Side-effect free: when CUDA is not initialised in this process the
    default comes back and CUDA stays down, so reading a knob (building an
    optimizer before ``init_process_group``, say) never brings the card
    up early.  The JAX package's counterpart is ``get_on_tpu``."""
    if not _cuda_initialized():
        return default
    return _load().get(key, default)
