"""Op-classification lists for the O1 / O4 casts (counterpart of
``apex_tpu/amp/lists``)."""
from . import torch_overrides  # noqa: F401
