"""Per-block kernels of the port: each module holds one hand-written
CUDA kernel's wrapper, its plain PyTorch version, and its launch count."""
