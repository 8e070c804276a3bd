"""Kernel L's (ProtXLNet's relative-position attention's) least time at
its calls' shapes over its device time in the traced window, in percent:
one call a layer for each of the program's "embed.batch" spans, at its
"rows" and "padded_len" (lib/work_xlnet.py:relattn_bound_s)."""

from portbench.lib.program import program_spans
from portbench.lib.work_xlnet import relattn_bound_s

NAME = "attention_xlnet_kernel"


def read(run):
    spans = program_spans(run)
    batches = [sp.counts for sp in spans or () if sp.name == "embed.batch"]
    if run.trace is None or not batches \
            or any("padded_len" not in c for c in batches):
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels if NAME in name)
    if busy <= 0:
        return None
    cfg = run.config
    bound = cfg["n_layer"] * sum(
        relattn_bound_s(c["rows"], cfg["n_head"], c["padded_len"],
                        cfg["d_head"]) for c in batches)
    return 100.0 * bound / busy
