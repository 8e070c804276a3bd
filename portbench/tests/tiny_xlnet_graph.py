"""Sizes at which protxlnet.long and pfam20.graph_online run on the CPU in
seconds, with the program's plain versions (tiny.py's, for these cells):
ProtXLNet at its published widths with two layers, so the check's layer
(drivers/embed_xlnet.py: CHECK_LAYER) is the last; the Pfam20 layout at
tiny.py's size."""

from portbench.tests.tiny import TINY_DB

OVERRIDES = {
    "protxlnet.long": {
        "config": {"n_layer": 2},
        "configs": {"pfam20": dict(TINY_DB, dim=1024)},
        "cell": {"units_per_call": 3, "pool_calls": 2, "check_proteins": 10**6,
                 "check_queries": 10**6,
                 "lengths": {"kind": "uniform", "n": 3, "lo": 40, "hi": 140}},
    },
    "pfam20.graph_online": {
        "config": TINY_DB,
        "cell": {"units_per_call": 8, "queries_per_call": 8,
                 "check_queries": 10**6},
    },
}
