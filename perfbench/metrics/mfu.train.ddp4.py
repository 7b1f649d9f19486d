"""% of the bf16 peak: model FLOPs of rank 0's batch over its traced
training steps (forward and backward) over their span, in the four-card
data-parallel cells."""

from perfbench import readers


def read(run):
    return readers.mfu(run)
