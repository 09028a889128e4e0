"""Hand-written CUDA kernels, their wrappers and their plain versions."""
