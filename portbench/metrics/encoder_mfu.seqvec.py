"""Model FLOPs of the real residues the traced window embedded with
SeqVec, over the window's seconds at the card's bf16 peak, in percent:
lib/work_seqvec.py:seqvec_model_flops of the "residues" of the program's
"embed.batch" spans (the power limit is in the result's device line)."""

from portbench.lib.peaks import PEAK_OPS
from portbench.lib.program import program_spans
from portbench.lib.work_seqvec import seqvec_model_flops


def read(run):
    spans = program_spans(run)
    batches = [sp.counts for sp in spans or () if sp.name == "embed.batch"]
    if run.trace is None or not run.trace.kernels or not batches:
        return None
    flops = sum(seqvec_model_flops(c["residues"], run.config)
                for c in batches)
    return 100.0 * flops / (run.trace.window_s() * PEAK_OPS["bf16"])
