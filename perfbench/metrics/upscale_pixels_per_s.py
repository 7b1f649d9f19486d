"""Output pixels of every request completed in the window, per window
second."""

from perfbench import readers


def read(run):
    return readers.rate(run)
