"""Encoder building blocks of the PyTorch port (kernels and search)."""
