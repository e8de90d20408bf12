"""apex_tpu_torch.serve — continuous-batching inference engine.

Paged KV cache (:mod:`.cache`), greedy/sampled decode (:mod:`.sample`),
prefill/decode steps with inference O-levels (:mod:`.engine`), and the
continuous-batching scheduler (:mod:`.schedule`).  The per-request latency
ledger is :mod:`apex_tpu_torch.telemetry.serve_ledger`.
"""
from .cache import CacheConfig, KVCacheExhaustedError, PagePool  # noqa: F401
from .engine import OLEVELS, InferenceEngine, prepare_olevel  # noqa: F401
from .sample import request_key, sample_batch, sample_token  # noqa: F401
from .schedule import ContinuousBatcher, Request, ServedResult  # noqa: F401
