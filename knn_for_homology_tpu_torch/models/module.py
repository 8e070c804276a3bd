"""An encoder's parameter tree as an nn.Module.

The port's encoders keep the JAX package's parameter trees (nested dicts and
lists of arrays, [in, out] weights) and a plain `encode(params, ...,
config)` function beside each model. `TreeEncoder` holds such a tree as
frozen nn.Parameters, so `.to()`, `.parameters()` and `state_dict()` work,
and its forward rebuilds the tree and calls the family's `encode`.
"""

from typing import Any, Callable, Dict

import torch
from torch import nn

SEP = ":"  # stands for "/" in parameter names (nn.Module forbids ".")


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"layers/0/q": leaf, ...}: one entry per leaf, in tree order."""
    out = {}
    if isinstance(tree, dict):
        for key, val in tree.items():
            out.update(flatten_tree(val, f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            out.update(flatten_tree(val, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    """The inverse of flatten_tree: all-digit keys become lists."""
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


class TreeEncoder(nn.Module):
    """A parameter tree of tensors as frozen nn.Parameters (inference only);
    forward(*inputs) is `encode_fn(params, *inputs, config)`. Subclasses set
    `encode_fn`."""

    encode_fn: Callable = None

    def __init__(self, config, params: Any):
        super().__init__()
        self.config = config
        self.leaves = nn.ParameterDict({
            key.replace("/", SEP): nn.Parameter(val, requires_grad=False)
            for key, val in flatten_tree(params).items()
        })

    def params(self) -> Any:
        return unflatten_tree({
            key.replace(SEP, "/"): val for key, val in self.leaves.items()
        })

    @torch.no_grad()
    def forward(self, *inputs):
        return type(self).encode_fn(self.params(), *inputs, self.config)
