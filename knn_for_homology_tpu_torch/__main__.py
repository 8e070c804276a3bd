"""Package CLI hub: `python -m knn_for_homology_tpu_torch <command> …`
(port of knn_for_homology_tpu/__main__.py, the same command names).

Mirrors the reference's `python -m <module>` entry points (Readme.md:29-43)
under one roof. The search, embedding and reproduction commands take
`--device` (cuda unless asked for cpu).
"""

import sys

COMMANDS = {
    "benchmark": ("pipelines.benchmark", "end-to-end kNN/hybrid benchmark on a dataset dir"),
    "embed": ("pipelines.embed", "embedding drivers (embed / embed-one / embed-all / embed-domains)"),
    "create-index": ("search.cli", "build + persist an LSH, graph or IVF index over train.npy"),
    "proteins-search": ("pipelines.pfam_proteins", "flat|lsh|graph|ivf full-sequence index build + search"),
    "cath-search": ("pipelines.cath", "all-vs-all search over every embedding npy"),
    "make-slices": ("data.slices", "slice long proteins into overlapping windows"),
    "pfam-full-sequences": ("data.pfam", "extract full sequences from pfamseq"),
    "build-dataset": ("data.builders", "seeded Pfam subset / family-count subset builders"),
    "make-fixtures": ("data.fixtures", "deterministic test-dataset generators"),
    "reverse-control": ("pipelines.reverse", "forward/reversed/shuffled embedding control"),
    "reproduce": ("pipelines.reproduce", "one-command paper reproduction (cath / pfam-proteins / uniref90)"),
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m knn_for_homology_tpu_torch <command> [args]\n")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:<22} {desc}")
        raise SystemExit(0 if argv else 2)
    command = argv[0]
    if command not in COMMANDS:
        print(f"unknown command {command!r}; run with --help for the list")
        raise SystemExit(2)
    module_name, _ = COMMANDS[command]
    import importlib

    module = importlib.import_module(f"knn_for_homology_tpu_torch.{module_name}")
    entry = getattr(module, "main", None) or getattr(module, "create_index_main")
    entry(argv[1:])


if __name__ == "__main__":
    main()
