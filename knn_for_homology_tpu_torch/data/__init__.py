from .dataset import Dataset
from .fasta import iter_fasta, read_fasta, write_fasta

__all__ = ["Dataset", "iter_fasta", "read_fasta", "write_fasta"]
