"""Native checkpoint format, T5 part (port of
knn_for_homology_tpu/models/convert.py).

A converted checkpoint is a flat .npz: one array per leaf of the parameter
tree, keyed by its path ("layers/0/attn/q"), bf16 leaves stored as fp32
(lossless), and the config and an optional vocabulary as JSON under
"__meta__". The JAX package writes it (`save_params`, after converting an
HF checkpoint); the port reads it with numpy alone and places the weights
on the card. `params_from_jax` carries a JAX parameter tree, as numpy
arrays, into the port's tensors, keeping the [in, out] weight layout.
"""

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .t5 import Params, T5Config


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for key, val in tree.items():
            out.update(_flatten(val, f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            out.update(_flatten(val, f"{prefix}{i}/"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().float().cpu().numpy()
        arr = np.asarray(tree)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)  # bf16 saves as fp32, losslessly
        out[prefix[:-1]] = arr
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def save_params(params: Any, path: Path, meta: Dict[str, Any] = None) -> None:
    """Write a parameter tree (numpy arrays or tensors) as a flat .npz."""
    flat = _flatten(params)
    if meta:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
    np.savez(path, **flat)
    if Path(path).suffix != ".npz":
        Path(str(path) + ".npz").replace(path)


def load_params(path: Path) -> Tuple[Any, Dict[str, Any]]:
    """→ (tree of numpy arrays, meta)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = {}
    if "__meta__" in flat:
        meta = json.loads(bytes(flat.pop("__meta__")).decode())
    return _unflatten(flat), meta


def params_from_jax(
    tree: Any, dtype: torch.dtype = torch.bfloat16, device="cuda"
) -> Params:
    """The JAX T5 parameter tree (leaves as numpy arrays, bf16 or fp32) →
    the same tree of torch tensors in `dtype` on `device`, the layout
    unchanged ([in, out] weights, [vocab, d] embedding, [buckets, heads]
    relative embedding): T5Encoder(config, params) takes it."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node).astype(np.float32)  # bf16 → fp32 is exact
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return convert(tree)


def load_t5_checkpoint(
    path: Path, device="cuda"
) -> Tuple[T5Config, Params, Optional[Dict[str, int]]]:
    """Load a converted .npz → (config, params on `device` in bf16, vocab).

    `vocab` is the residue → token-id table stored in the checkpoint's meta
    (key "vocab") when the source tokenizer's ordering differs from the
    published prot_t5 layout, else None (callers fall back to
    t5.PROTT5_VOCAB). An HF directory must first be converted with the JAX
    package's models/convert.py:convert_t5_from_hf."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory: convert the HF checkpoint to .npz first"
            " (knn_for_homology_tpu.models.convert.convert_t5_from_hf +"
            " save_params)"
        )
    tree, meta = load_params(path)
    config = T5Config(**{**meta.get("config", {}), "dtype": torch.bfloat16})
    params = params_from_jax(tree, config.dtype, device)
    vocab = meta.get("vocab")
    if vocab is not None:
        vocab = {str(k): int(v) for k, v in vocab.items()}
    return config, params, vocab
