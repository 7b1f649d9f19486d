"""% of the traced training steps' span in which the device ran nothing,
in the cells over the EDSR-baseline encoder."""

from perfbench import readers


def read(run):
    return readers.idle_share(run)
