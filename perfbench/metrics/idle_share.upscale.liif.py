"""% of the traced requests' span in which the device ran nothing, in the
cells over LIIF."""

from perfbench import readers


def read(run):
    return readers.idle_share(run)
