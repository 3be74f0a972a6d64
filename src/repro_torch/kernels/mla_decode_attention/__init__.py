"""Hand-written CUDA kernel with its plain PyTorch version."""
