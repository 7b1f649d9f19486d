"""% of rank 0's traced training steps' span in which its device ran
nothing, in the four-card data-parallel cells."""

from perfbench import readers


def read(run):
    return readers.idle_share(run)
