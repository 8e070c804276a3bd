"""Index persistence (port of knn_for_homology_tpu/search/io.py).

Same single-.npz format with a "kind" tag, so an index written by either
package loads in the other: kinds "flat", "ivf", "lsh" and "graph".
"""

from pathlib import Path

import numpy as np


def write_index(index, path: Path) -> None:
    state = index.state()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **state)
    if path.suffix != ".npz":  # numpy appends .npz; keep the exact name
        Path(str(path) + ".npz").replace(path)


def read_index(path: Path, device="cuda"):
    with np.load(path, allow_pickle=False) as data:
        state = {key: data[key] for key in data.files}
    kind = str(state["kind"])
    if kind == "lsh":
        from .lsh import LSHIndex

        return LSHIndex.from_state(state, device=device)
    if kind == "flat":
        from .flat import FlatIndex

        return FlatIndex.from_state(state, device=device)
    if kind == "ivf":
        from .ivf import IVFIndex

        return IVFIndex.from_state(state, device=device)
    if kind == "graph":
        from .graph import GraphIndex

        return GraphIndex.from_state(state, device=device)
    raise ValueError(f"unknown index kind {kind!r}")
