"""Kernel M's (SeqVec's recurrence's) least time at its launches' shapes
over its device time in the traced window, in percent: each "embed.batch"
span whose "embed.encode" counts kernel M's launches ("lstm_launches"),
each launch at the batch's "rows" and "residues"
(lib/work_seqvec.py:lstm_launch_bound_s). A program that does not count
them gives no number."""

from portbench.lib.program import program_spans
from portbench.lib.work_seqvec import lstm_launch_bound_s

NAME = "lstmp_bidir_kernel"


def encode_batches(spans, key):
    """[(batch counts, count)]: each "embed.encode" span's `key` count set
    beside the counts of the "embed.batch" span that holds it."""
    batches = sorted((sp for sp in spans if sp.name == "embed.batch"),
                     key=lambda sp: sp.t0)
    out = []
    for sp in spans:
        n = sp.counts.get(key, 0)
        if sp.name != "embed.encode" or n <= 0:
            continue
        holder = [b for b in batches if b.t0 <= sp.t0 and sp.t1 <= b.t1]
        if holder and "rows" in holder[-1].counts:
            out.append((holder[-1].counts, n))
    return out


def read(run):
    spans = program_spans(run)
    if run.trace is None or not spans:
        return None
    launches = encode_batches(spans, "lstm_launches")
    busy = sum(e - s for name, s, e in run.trace.kernels if NAME in name)
    if not launches or busy <= 0:
        return None
    bound = sum(n * lstm_launch_bound_s(c["rows"], c["residues"], run.config)
                for c, n in launches)
    return 100.0 * bound / busy
