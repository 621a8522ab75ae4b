"""Hand-written CUDA kernels of the port and their PyTorch wrappers."""
