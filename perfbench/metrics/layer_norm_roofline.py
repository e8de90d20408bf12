"""The layer-norm kernels' roofline bound over their device time."""
from perfbench.lib import readers


def read(rec):
    return readers.roofline(rec, "layer_norm")
