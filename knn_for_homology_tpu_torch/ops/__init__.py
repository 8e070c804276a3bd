"""Distance, top-k and alignment ops; CUDA kernels with plain twins."""
