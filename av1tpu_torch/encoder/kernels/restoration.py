"""Loop restoration of the private av1tpu profile (NORMATIVE): a port of
``av1tpu/encoder/kernels/restoration.py``.  It is not the spec-AV1 Wiener
filter (``specav1/torch_lr.py``).

The encoder picks a restoration mode per frame by comparing each
candidate's luma SSE against the source, codes it in the frame header
(lr_mode f(2)), and the decoder applies the same filter.  Presets:
symmetric separable 7-tap filters (a, b, c, d, c, b, a) with d = 128 −
2(a+b+c); rs(conv_h → conv_v, 7) per pass with edge replication.  Mode 0
is identity (off).  Planes may carry leading dimensions (one per tile
stripe).
"""

from __future__ import annotations

import numpy as np
import torch

# (a, b, c) per mode; d is derived.  Mild → stronger smoothing.
PRESETS = (
    None,              # 0: off
    (-1, 2, 8),        # 1: mild detail-preserving
    (0, 4, 14),        # 2: medium
    (1, 8, 22),        # 3: strong
)
N_MODES = len(PRESETS)


def _taps(mode: int) -> np.ndarray:
    a, b, c = PRESETS[mode]
    d = 128 - 2 * (a + b + c)
    return np.array([a, b, c, d, c, b, a], np.int32)


def edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge-replicate the last two dimensions by ``rows`` / ``cols`` a
    side (numpy's mode="edge")."""
    h, w = x.shape[-2:]
    ri = torch.arange(-rows, h + rows, device=x.device).clamp(0, h - 1)
    ci = torch.arange(-cols, w + cols, device=x.device).clamp(0, w - 1)
    return x[..., ri, :][..., ci]


def apply_restoration(plane: torch.Tensor, mode: int = 0,
                      maxval: int = 255) -> torch.Tensor:
    """Apply preset ``mode`` to int32 planes (..., H, W).  The mode is a
    host int: the frame's choice is read once per frame."""
    if mode == 0:
        return plane
    taps = [int(t) for t in _taps(mode)]
    h, w = plane.shape[-2:]
    p = edge_pad(plane, 0, 3)
    acc = None
    for t in range(7):
        term = taps[t] * p[..., t:t + w]
        acc = term if acc is None else acc + term
    tmp = edge_pad((acc + 64) >> 7, 3, 0)
    acc = None
    for t in range(7):
        term = taps[t] * tmp[..., t:t + h, :]
        acc = term if acc is None else acc + term
    return ((acc + 64) >> 7).clamp(0, maxval)


def mode_costs(src_y: torch.Tensor, rec_y: torch.Tensor,
               maxval: int = 255, tile_rows: int = 1) -> torch.Tensor:
    """Each mode's SSE against the source on 4x4-subsampled luma, the
    candidate filtered per tile stripe (stripe heights are multiples of
    16, so the stripe-local grid equals the global one): (N_MODES,)
    int64, exact, so the costs of stripes add up to the frame's."""
    src = src_y[::4, ::4].to(torch.int64)
    rec_s = rec_y[::4, ::4]
    h4, w4 = rec_s.shape
    st = rec_s.reshape(tile_rows, h4 // tile_rows, w4)
    return torch.stack([
        ((apply_restoration(st, m, maxval).reshape(h4, w4).to(torch.int64)
          - src) ** 2).sum() for m in range(N_MODES)])


def choose_mode(src_y: torch.Tensor, rec_y: torch.Tensor,
                maxval: int = 255, tile_rows: int = 1) -> int:
    """Encoder side: the SSE argmin over all modes (``mode_costs``).  The
    reference sums in float32; the port sums exactly and reads the choice
    once per frame on the host (one sync)."""
    costs = mode_costs(src_y, rec_y, maxval, tile_rows).tolist()
    return costs.index(min(costs))
