"""Spec-AV1 device encoders of the PyTorch port (keyframe + P-frame)."""
