"""Set-up seconds: from the harness's start to the first timed iteration,
warm-up included."""

from perfbench import readers


def read(run):
    return run.setup_s
