"""Share of the traced ResNet window with no device operation running."""
from perfbench.lib import readers


def read(rec):
    return readers.device_idle_pct(rec)
