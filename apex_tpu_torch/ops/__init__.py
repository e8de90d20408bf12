"""Kernel wrappers: each launches its CUDA kernel for a CUDA tensor and
takes its plain PyTorch version for a CPU tensor."""
