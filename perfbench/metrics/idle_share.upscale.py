"""% of the traced requests' span in which the device ran nothing."""

from perfbench import readers


def read(run):
    return readers.idle_share(run)
