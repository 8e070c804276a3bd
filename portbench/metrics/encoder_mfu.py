"""Model FLOPs of the real residues the traced window embedded, over the
window's seconds at the card's bf16 peak, in percent (lib/work.py's
t5_model_flops; the power limit is in the result's device line)."""

from portbench.lib.peaks import PEAK_OPS
from portbench.lib.work import t5_model_flops


def read(run):
    lengths = run.info.get("lengths")
    if run.trace is None or not run.trace.kernels or not lengths:
        return None
    calls = sum(1 for c in run.calls if not c.get("failed"))
    flops = calls * t5_model_flops(lengths, run.config)
    return 100.0 * flops / (run.trace.window_s() * PEAK_OPS["bf16"])
