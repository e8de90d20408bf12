"""Input pipeline: the seekable shard-addressed data plane.

Counterpart of ``apex_tpu/data``: checksummed ``.npz`` shard datasets with
a pure ``(seed, epoch, step, world) -> (shard, offset)`` addressing
function, so ``ShardedLoader(step)`` replays any global step bit for bit
(:mod:`.sharded`), and the loader pieces it rides on (:mod:`.loader`).
The JAX package's ``NativeLoader`` and ``native_available`` (the C++
prefetch ring) are not ported yet.
"""
from .loader import ArraySource, LoaderStallError, SyntheticSource
from .sharded import (INDEX, DatasetError, IndexMissingWarning,
                      ShardChecksumError, ShardIndex, ShardInfo,
                      ShardedDataset, ShardedLoader, build_index,
                      epoch_permutation, global_records, host_records,
                      load_index, locate_step, open_dataset,
                      steps_per_epoch)

__all__ = ["ArraySource", "LoaderStallError", "SyntheticSource",
           "INDEX", "DatasetError", "IndexMissingWarning",
           "ShardChecksumError", "ShardIndex", "ShardInfo",
           "ShardedDataset", "ShardedLoader", "build_index",
           "epoch_permutation", "global_records", "host_records",
           "load_index", "locate_step", "open_dataset",
           "steps_per_epoch"]
