"""Sizes at which seqvec.mix and pfam20.db_sharded run on the CPU in
seconds, with the program's plain versions (tiny.py's, for these cells):
SeqVec at narrow widths (the recurrence on kernel M's plain version), the
Pfam20 layout at tiny.py's size with its vectors as wide as SeqVec's;
the sharded search over two gloo ranks."""

from portbench.tests.tiny import TINY_DB

# the recurrence at tests/test_torch_seqvec.py's mid widths: at 16 / 32
# the bf16 roundings of a short protein's pooled vector read above the
# cell's limit, which is set for the published widths
TINY_SEQVEC = {"char_embed_dim": 4, "filters": [[1, 8], [2, 8], [3, 16]],
               "n_highway": 1, "proj_dim": 64, "lstm_dim": 512}

OVERRIDES = {
    "seqvec.mix": {
        "config": TINY_SEQVEC,
        "configs": {"pfam20": dict(TINY_DB, dim=128)},
        # batches of 16 and 24 rows: the second spans two of M's m-tiles
        "cell": {"units_per_call": 40, "pool_calls": 2, "token_budget": 1024,
                 "check_proteins": 10**6, "check_queries": 10**6,
                 "lengths": {"kind": "lognormal", "n": 40, "median": 20,
                             "sigma": 0.55, "lo": 1, "hi": 60}},
    },
    "pfam20.db_sharded": {
        "config": dict(TINY_DB, families=64, train_per_family=8,
                       test_per_family=8,
                       lengths=dict(TINY_DB["lengths"], n=64)),
        "cell": {"world": 2, "units_per_call": 256, "queries_per_call": 256,
                 "pool_calls": 2, "k": 50, "check_queries": 64},
    },
}
