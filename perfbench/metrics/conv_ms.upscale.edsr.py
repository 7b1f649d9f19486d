"""Device ms of the convolution kernels per traced request, in the cells
over the EDSR-baseline encoder."""

from perfbench import readers


def read(run):
    return readers.group_ms(run, "conv")
