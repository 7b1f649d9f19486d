"""% of its roofline: the least time of the traced requests' LIIF decodes
(their per-query FLOPs and bytes, ``counts_liif.decoder_call``) over the
device time of the ``liif_decoder`` kernels."""

from perfbench import readers


def read(run):
    return readers.roofline(run, "liif_decoder", run.stretch_decoder_least_s)
