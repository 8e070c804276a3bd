"""PyTorch + CUDA port of knn_for_homology_tpu: the search-and-rescore path,
the headline bench and the ProtT5 encoder path (sequences → pooled
embeddings → neighbours).

The JAX package next door stays the reference: every function here is held
against its JAX counterpart on the same numpy inputs (tests/test_torch_*.py).
Plain tensor code is PyTorch; the fused kernels are CUDA C++ for sm_90a
(csrc/), built with nvcc at first use (ops/_build.py) and bound with ctypes.

Device rule: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the kernel's plain PyTorch version — callers choose with an explicit
`device` argument, never by probing for a GPU.

The port imports nothing of the JAX package, not even its numpy-only
modules: it keeps its own copies of config, data (dataset, fasta), eval
(metrics, figures), interop (the MMseqs2 formats and drivers) and utils
(logging, timing), held equal to the originals by
tests/test_torch_shared_copies.py.
"""

import torch

# fp32 parity with the reference's Precision.HIGHEST matmuls
# (knn_for_homology_tpu/ops/distance.py): TF32 keeps ~3 decimal digits,
# enough to swap near-tie neighbour ranks.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
