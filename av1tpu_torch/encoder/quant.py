# Copied from av1tpu/encoder/quant.py (quantize_block / dequantize_block
# are torch functions here).
"""Quantization: qindex → step tables, quantize/dequantize.

The qindex space is AV1-shaped (base_q_idx 0..255 coded in the frame
header) but the step tables are this codec's own normative definition,
generated from a smooth exponential matching the AV1 8-bit table's span
(ac: 4 → ~1828 across 0..255).  They are the private av1tpu profile's
(``legacy/``); the spec-AV1 path uses the standard tables.

Steps apply to the transform scale of
av1tpu_torch.encoder.kernels.transforms (orthonormal coefficients × gain
4).  Dequantization is integer (level × step) and is part of the
normative reconstruction path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

QINDEX_RANGE = 256


@functools.lru_cache(maxsize=None)
def ac_quant_table(bit_depth: int = 8) -> np.ndarray:
    """Normative AC step per qindex.  Smooth exponential, 4..~1828 (8-bit)."""
    q = np.arange(QINDEX_RANGE, dtype=np.float64)
    steps = np.round(4.0 * np.exp2(q / 28.8)).astype(np.int32)
    if bit_depth == 10:
        steps = steps * 4  # coefficients carry 2 extra bits
    return steps


@functools.lru_cache(maxsize=None)
def dc_quant_table(bit_depth: int = 8) -> np.ndarray:
    """Normative DC step: ~88% of AC (DC quantized a little finer)."""
    ac = ac_quant_table(bit_depth)
    return np.maximum(4, np.round(ac * 0.88)).astype(np.int32)


def ac_q(qindex: int, bit_depth: int = 8) -> int:
    return int(ac_quant_table(bit_depth)[qindex])


def dc_q(qindex: int, bit_depth: int = 8) -> int:
    return int(dc_quant_table(bit_depth)[qindex])


def _steps(n: int, dc_step: int, ac_step: int, dtype, device):
    steps = torch.full((n, n), ac_step, dtype=dtype, device=device)
    steps[0, 0] = dc_step
    return steps


def quantize_block(coeffs: torch.Tensor, dc_step: int, ac_step: int,
                   deadzone: float = 0.6) -> torch.Tensor:
    """coeff (…, N, N) float32 → int32 levels with a deadzone.

    level = sign * floor(|c| / step + (1 - deadzone)) in float32 — deadzone
    0.5 is round-to-nearest; larger biases toward zero (cheaper rate).  The
    profile keeps its own deadzone of 0.6 (not the config's qround).
    """
    steps = _steps(coeffs.shape[-1], dc_step, ac_step, torch.float32,
                   coeffs.device)
    mag = coeffs.to(torch.float32).abs()
    lvl = torch.floor(mag / steps + (1.0 - deadzone)).to(torch.int32)
    return torch.where(coeffs < 0, -lvl, lvl)


def dequantize_block(levels: torch.Tensor, dc_step: int,
                     ac_step: int) -> torch.Tensor:
    """Integer dequantization (normative): dq = level * step, int32."""
    steps = _steps(levels.shape[-1], dc_step, ac_step, torch.int32,
                   levels.device)
    return levels.to(torch.int32) * steps
