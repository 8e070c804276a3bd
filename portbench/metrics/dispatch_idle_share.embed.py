"""Share of the traced window in which the card was idle while the host
was still enqueuing the encoder's or the pooling's work, in percent: idle
time put down to the program's "embed.encode" and "embed.pool" spans."""

from portbench.lib.program import idle_by_span, program_spans

DISPATCH = ("embed.encode", "embed.pool")


def read(run):
    spans = program_spans(run)
    if spans is None or not run.trace.kernels:
        return None
    idle = idle_by_span(run, spans)
    return 100.0 * sum(idle.get(n, 0.0) for n in DISPATCH) \
        / run.trace.window_s()
