"""% of the TF32 peak: model FLOPs of the traced requests (forward) over
their span."""

from perfbench import readers


def read(run):
    return readers.mfu(run)
