"""% of the TF32 peak: model FLOPs of the traced requests (forward, LIIF's
count: ``counts_liif.py``) over their span."""

from perfbench import readers


def read(run):
    return readers.mfu(run)
