"""Real residues over the padded tokens of the batches the window ran, in
percent, as the program counts them: the "residues" and "tokens" of its
"embed.batch" spans (rows x padded length)."""

from portbench.lib.program import program_spans


def read(run):
    spans = program_spans(run)
    batches = [sp.counts for sp in spans or () if sp.name == "embed.batch"]
    tokens = sum(c["tokens"] for c in batches)
    if not tokens:
        return None
    return 100.0 * sum(c["residues"] for c in batches) / tokens
