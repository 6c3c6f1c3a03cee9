"""ImageNet-style ResNet-50 training on a CUDA GPU."""
