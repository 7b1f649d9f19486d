"""Output pixels of every request completed in the window, per window
second, in the cells over the EDSR-baseline encoder."""

from perfbench import readers


def read(run):
    return readers.rate(run)
