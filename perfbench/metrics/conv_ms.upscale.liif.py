"""Device ms of the convolution kernels per traced request, in the cells
over LIIF (the encoder and the imnet's feature conv)."""

from perfbench import readers


def read(run):
    return readers.group_ms(run, "conv")
