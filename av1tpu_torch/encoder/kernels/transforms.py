"""Forward/inverse 2-D transforms (DCT / ADST / identity) of the private
av1tpu profile: a port of ``av1tpu/encoder/kernels/transforms.py``.

* **Forward (search side)** — float32 orthonormal matmuls, associated as
  the reference's einsum lowers them (the row basis first, then the
  column basis) and summed in the order of its float32 dot (``_dot``):
  the levels are transmitted, and a coefficient on a quantizer
  boundary (an integer on synthetic content) rounds the reference's
  way, on the CPU and on the card alike.
* **Inverse (commit side, NORMATIVE)** — integer matrix multiplies with
  one rounding per pass, shared bit-exactly by the encoder's recon and
  the decoder.  The reference splits each value into three 8-bit limbs
  so that float32 sums stay exact on the MXU; here each product is one
  float64 matmul, exact below 2^53 (|x| < 2^23, row L1 < 2^15, so every
  sum stays below 2^38) on the CPU and on the card, whose integer
  matmuls are not available.  The result is wrapped to int32 as the
  reference's limb recombination wraps.

Scaling contract (the codec's normative definition):
  basis  B_N = round(1024 * C_N)  (C_N orthonormal rows)   — |B| ≤ 1024
  fwd    coeff = round(4 * C x C^T)                        — gain G = 4
  inv    x = rs( B^T @ rs(Y @ B, 11) , 11 )  with rs = round_shift
  Y (dequantized coeffs) clamped to ±2^15; pass-1 output clamped to ±2^18.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SIZES = (4, 8, 16, 32, 64)
BASIS_BITS = 10          # basis scale 2^10
PASS_SHIFT = 11          # per-pass rounding of the inverse
FWD_GAIN = 4.0
COEF_CLAMP = 1 << 15     # dequantized-coefficient clamp
INTER_CLAMP = 1 << 18    # pass-1 clamp

# transform type enum (bitstream order fixed by the syntax)
DCT_DCT = 0
ADST_ADST = 1
ADST_DCT = 2     # ADST rows (vertical), DCT cols
DCT_ADST = 3
IDTX = 4
N_TX_TYPES = 5


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II: rows are basis functions."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[0] /= np.sqrt(2.0)
    return m


def adst_matrix(n: int) -> np.ndarray:
    """Orthonormal DST (ADST flavor): rows are basis functions."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    return (2.0 / np.sqrt(2 * n + 1)
            * np.sin(np.pi * (2 * i + 1) * (k + 1) / (2 * n + 1)))


def identity_matrix(n: int) -> np.ndarray:
    return np.eye(n)


@functools.lru_cache(maxsize=None)
def _float_basis(n: int, kind: str) -> np.ndarray:
    if kind == "dct":
        return dct_matrix(n)
    if kind == "adst":
        return adst_matrix(n)
    return identity_matrix(n)


@functools.lru_cache(maxsize=None)
def _int_basis(n: int, kind: str) -> np.ndarray:
    """Normative integer basis: round(1024 * C)."""
    b = np.round(_float_basis(n, kind) * (1 << BASIS_BITS))
    assert np.abs(b).max() <= (1 << BASIS_BITS)
    return b.astype(np.float32)  # float32 holding exact small ints


def _kinds(tx_type: int) -> tuple[str, str]:
    """(row_kind, col_kind): row = vertical basis, col = horizontal."""
    return {
        DCT_DCT: ("dct", "dct"),
        ADST_ADST: ("adst", "adst"),
        ADST_DCT: ("adst", "dct"),
        DCT_ADST: ("dct", "adst"),
        IDTX: ("id", "id"),
    }[tx_type]


_bases: dict = {}


def _basis(n: int, kind: str, integer: bool, device) -> torch.Tensor:
    """The basis as a tensor on ``device``: the float32 orthonormal one,
    or the normative integer one as float64."""
    key = (n, kind, integer, str(device))
    t = _bases.get(key)
    if t is None:
        if integer:
            t = torch.as_tensor(_int_basis(n, kind), dtype=torch.float64)
        else:
            t = torch.as_tensor(_float_basis(n, kind), dtype=torch.float32)
        t = _bases[key] = t.to(device)
    return t


def round_shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """(x + 2^(s-1)) >> s with arithmetic shift."""
    return (x + (1 << (s - 1))) >> s


def _exact_int32(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor of exact integers as int32, wrapping modulo 2^32
    as the reference's int32 limb recombination does."""
    return x.to(torch.int64).to(torch.int32)


def _accumulators(n: int, rows: int) -> int:
    """The interleaved accumulators of the reference's float32 dot of
    ``rows`` x n by n x n: XLA's CPU GEMM sums the contraction in 4
    FMA accumulators (j mod 4) at n = 4..16 and in 2 at n = 32, and in
    one where the dot has a single block (rows == n) at n = 4 and 32."""
    if rows <= n and n in (4, 32):
        return 1
    return 2 if n == 32 else 4


def _fma32(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32(p + c), rounded once: ``p`` a float64 product of two
    float32 values (exact), ``c`` a float32 accumulator.  The float64 sum
    is rounded to odd (its error, from TwoSum, moves an even result to
    its odd neighbour), so that the rounding to float32 after it is the
    correct one: a plain float64 sum would round twice."""
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((e != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _dot(a: torch.Tensor, m: torch.Tensor, s: int) -> torch.Tensor:
    """float32 out[..., p, i] = sum_j a[..., p, j] * m[j, i] in a fixed
    order: s accumulators, the j-th product fused into accumulator
    j mod s (an FMA, ``_fma32``), the accumulators then summed pairwise
    in float32.  Elementwise float
    arithmetic only, so the CPU and the card give the same bits."""
    n = a.shape[-1]
    a64 = a.to(torch.float64)
    m64 = m.to(torch.float64)
    acc = torch.zeros((s,) + a.shape[:-1] + m.shape[-1:], dtype=torch.float32,
                      device=a.device)
    for j0 in range(0, n, s):
        # (s, ..., p, 1) * (s, 1, i)
        prod = (a64[..., j0:j0 + s].movedim(-1, 0).unsqueeze(-1)
                * m64[j0:j0 + s].reshape((s,) + (1,) * (a.dim() - 1)
                                         + m.shape[-1:]))
        acc = _fma32(prod, acc)
    while acc.shape[0] > 1:
        acc = acc[0::2] + acc[1::2]
    return acc[0]


def fwd_txfm(blocks: torch.Tensor, tx_type: int = DCT_DCT,
             ref_blocks: int | None = None) -> torch.Tensor:
    """Forward transform of residual blocks (B, N, N) → float32:
    G * (C_row @ x) @ C_col^T, each product summed in the reference's
    float32 order (``_dot``).  ``ref_blocks``: the block count of the
    reference's dot where it differs from B (its padded wavefront
    lanes)."""
    n = blocks.shape[-1]
    rk, ck = _kinds(tx_type)
    cr = _basis(n, rk, False, blocks.device)
    cc = _basis(n, ck, False, blocks.device)
    s = _accumulators(n, n * (blocks.shape[0] if ref_blocks is None
                              else ref_blocks))
    x = blocks.to(torch.float32)
    # t[b, k, i] = sum_j x[b, j, k] cr[i, j]; y[b, i, l] = sum_k t cc[l, k]
    t = _dot(x.transpose(1, 2), cr.T, s)
    y = _dot(t.transpose(1, 2), cc.T, s)
    return FWD_GAIN * y


def inv_txfm(coeffs: torch.Tensor, tx_type: int = DCT_DCT) -> torch.Tensor:
    """NORMATIVE inverse transform: int coeffs (B, N, N) → int32 residual.

    x = rs(B_row^T @ rs(clamp(Y) @ B_col, 11), 11), every step exact."""
    n = coeffs.shape[-1]
    rk, ck = _kinds(tx_type)
    br = _basis(n, rk, True, coeffs.device)
    bc = _basis(n, ck, True, coeffs.device)
    y = coeffs.to(torch.int32).clamp(-COEF_CLAMP, COEF_CLAMP - 1)
    t = round_shift(_exact_int32(torch.matmul(y.to(torch.float64), bc)),
                    PASS_SHIFT)
    t = t.clamp(-INTER_CLAMP, INTER_CLAMP - 1)
    return round_shift(_exact_int32(torch.matmul(br.T, t.to(torch.float64))),
                       PASS_SHIFT)
