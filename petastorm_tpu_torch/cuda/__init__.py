"""CUDA side of the port: the device loader and the kernel build helper."""
