"""Device ms a ResNet step of kernels that are not the port's."""
from perfbench.lib import readers


def read(rec):
    return readers.torch_kernel_ms(rec)
