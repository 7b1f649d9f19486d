"""% of the bf16 peak: model FLOPs of the traced steps (forward and
backward) over their span."""

from perfbench import readers


def read(run):
    return readers.mfu(run)
