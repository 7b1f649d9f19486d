"""% of the TF32 peak: model FLOPs of the traced requests (forward) over
their span, in the cells over the EDSR-baseline encoder."""

from perfbench import readers


def read(run):
    return readers.mfu(run)
