"""Hand-written CUDA kernels of the port, one package per kernel family."""
