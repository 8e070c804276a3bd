"""Real residues over the padded tokens of the batches the window ran, in
percent (the embedder's length-sorted token-budget batches)."""


def read(run):
    batches = run.info.get("batches")
    if not batches:
        return None
    padded = sum(rows * length for rows, length in batches)
    return 100.0 * sum(run.info["lengths"]) / padded
