"""Device ms of the convolution kernels per traced training step."""

from perfbench import readers


def read(run):
    return readers.group_ms(run, "conv")
