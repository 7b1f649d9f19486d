"""HR pixels of every training step of the window, per window second."""

from perfbench import readers


def read(run):
    return readers.rate(run)
