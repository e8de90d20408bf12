"""Input pipeline: the seekable shard-addressed data plane.

Counterpart of ``apex_tpu/data``: checksummed ``.npz`` shard datasets with
a pure ``(seed, epoch, step, world) -> (shard, offset)`` addressing
function, so ``ShardedLoader(step)`` replays any global step bit for bit
(:mod:`.sharded`), and the native prefetch loader (:class:`NativeLoader`
over the C++ ring, :func:`native_available`) with the loader pieces the
data plane rides on (:mod:`.loader`).
"""
from .loader import (ArraySource, LoaderStallError, NativeLoader,
                     SyntheticSource, native_available)
from .sharded import (INDEX, DatasetError, IndexMissingWarning,
                      ShardChecksumError, ShardIndex, ShardInfo,
                      ShardedDataset, ShardedLoader, build_index,
                      epoch_permutation, global_records, host_records,
                      load_index, locate_step, open_dataset,
                      steps_per_epoch)

__all__ = ["ArraySource", "LoaderStallError", "NativeLoader",
           "SyntheticSource", "native_available",
           "INDEX", "DatasetError", "IndexMissingWarning",
           "ShardChecksumError", "ShardIndex", "ShardInfo",
           "ShardedDataset", "ShardedLoader", "build_index",
           "epoch_permutation", "global_records", "host_records",
           "load_index", "locate_step", "open_dataset",
           "steps_per_epoch"]
