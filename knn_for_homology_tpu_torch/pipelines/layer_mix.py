"""SeqVec layer-mix sweep — barycentric weights over (CharCNN, LSTM1, LSTM2);
port of knn_for_homology_tpu/pipelines/layer_mix.py.

Parity with the reference (reference: cath/compare_seqvec_layer.py:44-64):
a grid of convex layer combinations, each searched all-vs-all and scored by
top-1 accuracy. The JAX package maps the grid with `lax.map` on device; here
a loop over the weights on an explicit device ("cuda" unless the caller
asks for the CPU): each step mixes the layers, L2-normalises, runs the
top-2 self-search and reduces to an accuracy scalar, so only the [W]
accuracy vector leaves the device.
"""

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distance import l2_normalize
from ..ops.topk import oneshot_topk


def barycentric_grid(step: float = 0.1) -> np.ndarray:
    """[W, 3] weights with w0+w1+w2=1 on a simplex grid."""
    n = int(round(1.0 / step))
    weights = []
    for i in range(n + 1):
        for j in range(n + 1 - i):
            weights.append((i * step, j * step, 1.0 - (i + j) * step))
    return np.asarray(weights, dtype=np.float32)


def _sweep(
    layers: torch.Tensor, weights: torch.Tensor, same_family: torch.Tensor
) -> torch.Tensor:
    """layers [3, N, d]; weights [W, 3]; same_family [N, N] bool.
    → accuracy [W]: fraction of queries whose top non-self hit shares the
    query's family."""
    rows = torch.arange(layers.shape[1], device=layers.device)
    acc = []
    for w in weights:
        mixed = l2_normalize(torch.einsum("l,lnd->nd", w, layers))
        _, ids = oneshot_topk(mixed, mixed, 2, metric="ip")
        # column 0 is the self hit (cosine 1.0); column 1 the real top hit
        correct = same_family[rows, ids[:, 1].long()]
        acc.append(correct.to(torch.float32).mean())
    return torch.stack(acc)


def layer_mix_sweep(
    layer_embeddings: List[np.ndarray],
    families: np.ndarray,
    step: float = 0.1,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (weights [W, 3], accuracy [W]). families: int codes per row."""
    device = resolve_device(device)
    layers = torch.from_numpy(
        np.stack([np.asarray(e, dtype=np.float32) for e in layer_embeddings])
    ).to(device)
    weights = barycentric_grid(step)
    fams = np.asarray(families)
    same = torch.from_numpy(fams[:, None] == fams[None, :]).to(device)
    acc = _sweep(layers, torch.from_numpy(weights).to(device), same)
    return weights, acc.cpu().numpy()


def ternary_figure(weights: np.ndarray, acc: np.ndarray, figures_dir, name="layer-mix"):
    """Ternary-style scatter of the sweep (reference:
    cath/compare_seqvec_layer.py:106-125) + raw npz."""
    from ..eval.figures import _plt, endfig, save_raw

    save_raw(figures_dir, name + "-data", weights=weights, accuracy=acc)
    plt = _plt()
    # project the simplex onto 2-D
    x = weights[:, 1] + 0.5 * weights[:, 2]
    y = np.sqrt(3) / 2 * weights[:, 2]
    sc = plt.scatter(x, y, c=acc, s=120, cmap="viridis")
    plt.colorbar(sc, label="QrawTop1")
    for corner, label in [
        ((0, 0), "CharCNN"),
        ((1, 0), "LSTM1"),
        ((0.5, np.sqrt(3) / 2), "LSTM2"),
    ]:
        plt.annotate(label, corner)
    plt.axis("off")
    endfig(figures_dir, name)
