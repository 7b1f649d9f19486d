"""The 95th percentile of the latency of every request of the window, ms."""

from perfbench import readers


def read(run):
    return readers.latency_ms(run, 95)
