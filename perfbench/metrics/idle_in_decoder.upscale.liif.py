"""% of the traced requests' span in which the device ran nothing and the
host was in the decoder's program spans (``spans.py``), in the cells over
LIIF; None where the trace holds no decoder span (a program whose LIIF
opens none)."""

from perfbench import spans


def read(run):
    t = run.trace
    if t is None or not any(spans.layer_of(n) == "decoder"
                            for n, _, _ in spans.program_spans(t)):
        return None
    return spans.idle_share(run, "decoder")
