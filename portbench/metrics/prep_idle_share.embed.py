"""Share of the traced window in which the card was idle while the host
was in the embedder's own work around the encoder (batching, tokenising,
the copies up and down, the un-sort, the loop between them), in percent:
idle time put down to the innermost program span open at the time."""

from portbench.lib.program import idle_by_span, program_spans

PREP = ("embed", "embed.batching", "embed.batch", "embed.tokenize",
        "embed.h2d", "embed.d2h", "embed.unsort")


def read(run):
    spans = program_spans(run)
    if spans is None or not run.trace.kernels:
        return None
    idle = idle_by_span(run, spans)
    return 100.0 * sum(idle.get(n, 0.0) for n in PREP) / run.trace.window_s()
