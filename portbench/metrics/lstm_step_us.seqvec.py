"""What one serial step of kernel M costs: its device time in the traced
window over the serial steps its launches ran (the "lstm_steps" the
program's "embed.encode" spans count), in microseconds. A program that
does not count them gives no number."""

from portbench.lib.program import program_spans

NAME = "lstmp_bidir_kernel"


def read(run):
    spans = program_spans(run)
    if run.trace is None or not spans:
        return None
    steps = sum(sp.counts.get("lstm_steps", 0) for sp in spans
                if sp.name == "embed.encode")
    busy = sum(e - s for name, s, e in run.trace.kernels if NAME in name)
    if steps <= 0 or busy <= 0:
        return None
    return 1e6 * busy / steps
