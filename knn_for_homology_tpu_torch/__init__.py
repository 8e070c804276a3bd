"""PyTorch + CUDA port of knn_for_homology_tpu's search-and-rescore path.

The JAX package next door stays the reference: every function here is held
against its JAX counterpart on the same numpy inputs (tests/test_torch_*.py).
Plain tensor code is PyTorch; the fused kernels are CUDA C++ for sm_90a
(csrc/), built with nvcc at first use (ops/_build.py) and bound with ctypes.

Device rule: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the kernel's plain PyTorch version — callers choose with an explicit
`device` argument, never by probing for a GPU.

The dataset contract, metrics, figures, MMseqs2 formats and logging are
shared with the JAX package (those modules import no jax), so there is one
copy of each.
"""

import torch

# fp32 parity with the reference's Precision.HIGHEST matmuls
# (knn_for_homology_tpu/ops/distance.py): TF32 keeps ~3 decimal digits,
# enough to swap near-tie neighbour ranks.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
