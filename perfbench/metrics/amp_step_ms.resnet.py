"""Device span of amp_step in the ResNet step."""
from perfbench.lib import readers


def read(rec):
    return readers.amp_step_ms(rec)
