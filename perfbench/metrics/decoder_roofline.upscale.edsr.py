"""% of its roofline: the least time of the traced requests' decodes over
the decoder kernels' device time, in the cells over the EDSR-baseline
encoder."""

from perfbench import readers


def read(run):
    return readers.roofline(run, "decoder", run.stretch_decoder_least_s)
