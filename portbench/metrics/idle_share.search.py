"""Share of the traced window with no kernel, copy or memset on the card,
in percent."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
