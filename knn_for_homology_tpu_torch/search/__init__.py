"""Flat, LSH, IVF and graph indexes, index persistence and alignment
rescoring."""

from .flat import FlatIndex, knn_search
from .graph import GraphIndex
from .io import read_index, write_index
from .ivf import IVFIndex
from .lsh import LSHIndex

__all__ = [
    "FlatIndex",
    "GraphIndex",
    "IVFIndex",
    "knn_search",
    "LSHIndex",
    "read_index",
    "write_index",
]
