"""Index-builder CLI (port of knn_for_homology_tpu/search/cli.py) — parity
with the reference's console script ``seqvec_search_create_index``
(reference: seqvec_search/create_index.py:18-47, pyproject.toml:28-30):
builds an index over a dataset's train.npy and persists it. The reference
script only builds FAISS LSH; ``--kind`` additionally exposes the graph
and IVF ANN indexes (incl. IVF's memory-lean int8-slab layout) through the
same contract.

Usage: python -m knn_for_homology_tpu_torch.search.cli --index FILE
       [--dir DIR] [--kind lsh|graph|ivf] [--param 1024] [--lean]
       [--device cuda|cpu]
"""

import argparse
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..utils.logging import configure_logging
from .io import write_index

logger = logging.getLogger(__name__)


def create_index_main(args: Optional[Sequence[str]] = None) -> None:
    configure_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--dir",
        type=Path,
        default=Path(),
        help="The name of the directory containing the database",
    )
    parser.add_argument(
        "--index", type=Path, required=True, help="The location to write the index to"
    )
    parser.add_argument(
        "--kind",
        choices=["lsh", "graph", "ivf"],
        default="lsh",
        help="Index family: lsh (reference parity, the default), graph"
        " (beam-search ANN), or ivf (k-means-routed int8 cluster slabs)",
    )
    parser.add_argument(
        "--param",
        type=int,
        default=1024,
        help="The tuning parameter of the index. lsh: hash bits (higher ="
        " higher precision); graph: beam width; ivf: nprobe*64 (e.g. 1024"
        " -> nprobe 16)",
    )
    parser.add_argument(
        "--lean",
        action="store_true",
        help="ivf only: drop the fp32 rows after build (int8-slab-only"
        " layout, under half of FAISS HNSW's memory; shortlists are"
        " rescored from the dequantised slabs)",
    )
    parser.add_argument(
        "--device", default="cuda", help="cuda (default) or cpu"
    )
    opts = parser.parse_args(args)
    if opts.lean and opts.kind != "ivf":
        # loud, not silent: an ignored explicit flag masks a wrong layout
        parser.error("--lean applies to --kind ivf only")

    train = opts.dir / "train.npy"
    logger.info("Loading database from %s", train)
    embeddings = np.load(train)
    if opts.kind == "graph":
        from .graph import GraphIndex

        logger.info(
            "Building graph index (beam %d) on %s", opts.param,
            embeddings.shape,
        )
        index = GraphIndex(beam_width=opts.param, device=opts.device).add(
            embeddings
        )
    elif opts.kind == "ivf":
        from .ivf import IVFIndex

        nprobe = max(1, opts.param // 64)
        logger.info(
            "Building %sIVF index (nprobe %d) on %s",
            "lean " if opts.lean else "", nprobe, embeddings.shape,
        )
        index = IVFIndex(
            nprobe=nprobe, store_fp32=not opts.lean, device=opts.device
        ).add(embeddings)
    else:
        from .lsh import LSHIndex

        logger.info(
            "Building %d-bit LSH index on %s", opts.param, embeddings.shape
        )
        index = LSHIndex(
            embeddings.shape[1], nbits=opts.param, device=opts.device
        ).add(embeddings)
    logger.info("Writing the %s index to %s", opts.kind, opts.index)
    write_index(index, opts.index)


if __name__ == "__main__":
    create_index_main()
