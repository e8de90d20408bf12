"""The ResNet step's model FLOPs over wall time, as a share of the bf16 peak."""
from perfbench.lib import readers


def read(rec):
    return readers.step_mfu(rec)
