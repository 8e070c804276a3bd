"""Kernel I's (the encoder's short attention's) least time at its calls'
shapes over its device time in the traced window, in percent: the
program's "embed.batch" spans whose "embed.encode" counts kernel I's
launches ("short_launches"), each launch at the batch's "rows" and
"padded_len" (lib/work.py:attention_bound_s). A program that does not
count them gives no number."""

import bisect

from portbench.lib.program import program_spans
from portbench.lib.work import attention_bound_s

NAME = "attention_t5_kernel<1"


def short_batches(spans):
    """[(rows, padded length, launches)] of the batches whose encode
    launched kernel I: each "embed.encode" span set in the "embed.batch"
    span that holds it."""
    batches = sorted((sp for sp in spans if sp.name == "embed.batch"),
                     key=lambda sp: sp.t0)
    starts = [sp.t0 for sp in batches]
    out = []
    for sp in spans:
        launches = sp.counts.get("short_launches", 0)
        if sp.name != "embed.encode" or launches <= 0:
            continue
        at = bisect.bisect_right(starts, sp.t0) - 1
        if at < 0 or sp.t1 > batches[at].t1:
            continue
        counts = batches[at].counts
        if "padded_len" in counts:
            out.append((counts["rows"], counts["padded_len"], launches))
    return out


def read(run):
    spans = program_spans(run)
    if run.trace is None or not spans:
        return None
    batches = short_batches(spans)
    busy = sum(e - s for name, s, e in run.trace.kernels if NAME in name)
    if not batches or busy <= 0:
        return None
    cfg = run.config
    bound = sum(launches * attention_bound_s(rows, cfg["num_heads"], length,
                                             cfg["d_kv"])
                for rows, length, launches in batches)
    return 100.0 * bound / busy
