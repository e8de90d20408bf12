"""Distributed training over process groups (counterpart of
``apex_tpu/parallel``, a subset so far: process-group set-up and the flat
collectives the ZeRO optimizers ride on; DDP, weight-update sharding,
overlap and the parallel engines are queued in ROADMAP.md)."""
from . import collectives, mesh  # noqa: F401
from .collectives import CollectiveSpec  # noqa: F401
from .mesh import group_rank, group_size, initialize_distributed  # noqa: F401
