"""Mean milliseconds of one batch's rescoring in the traced window: the hit
sequences, align_hits and the ranking by E-value."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.named_spans("align")
    if not spans:
        return None
    return 1e3 * sum(e - s for _, s, e in spans) / len(spans)
