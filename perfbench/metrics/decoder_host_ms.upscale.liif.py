"""Host ms a traced request in the decoder's preparation spans
(``decoder.prepare``: LIIF's corner index maps, the cell and their
uploads), in the cells over LIIF; None where the trace holds no such
span (a program whose LIIF opens none)."""

from perfbench import spans

PREPARE = "decoder.prepare"


def read(run):
    t = run.trace
    if t is None or PREPARE not in {n for n, _, _ in spans.program_spans(t)}:
        return None
    return spans.host_ms(run, [PREPARE])
