"""Hand-written CUDA kernels of the main path, each beside its plain version."""
