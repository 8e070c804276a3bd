"""Mean milliseconds of one batch's FlatIndex.search in the traced window."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.named_spans("search")
    if not spans:
        return None
    return 1e3 * sum(e - s for _, s, e in spans) / len(spans)
