"""Index persistence (port of knn_for_homology_tpu/search/io.py).

Same single-.npz format with a "kind" tag, so a flat index written by
either package loads in the other. Kinds "flat" and "ivf" are ported.
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
    if kind == "flat":
        from .flat import FlatIndex

        return FlatIndex.from_state(state, device=device)
    if kind == "ivf":
        from .ivf import IVFIndex

        return IVFIndex.from_state(state, device=device)
    if kind in ("lsh", "graph"):
        raise NotImplementedError(
            f"index kind {kind!r} is not ported yet (see ROADMAP.md)"
        )
    raise ValueError(f"unknown index kind {kind!r}")
