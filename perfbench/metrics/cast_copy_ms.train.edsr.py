"""Device ms of the copy, cast and concatenation kernels per traced
training step, in the cells over the EDSR-baseline encoder."""

from perfbench import readers


def read(run):
    return readers.group_ms(run, "cast_copy")
