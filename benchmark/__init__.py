"""The benchmark of av1tpu_torch (see run.py)."""
