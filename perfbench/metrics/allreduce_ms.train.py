"""Device ms of the NCCL kernels per traced training step, on rank 0 of the
data-parallel cells: the all-reduce of the flattened gradients and of
the loss."""

from perfbench import readers


def read(run):
    return readers.group_ms(run, "allreduce")
