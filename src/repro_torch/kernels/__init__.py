"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, the
build, and the device resolver."""
