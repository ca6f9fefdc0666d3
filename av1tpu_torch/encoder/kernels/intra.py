"""Intra prediction of the private av1tpu profile (NORMATIVE): a port of
``av1tpu/encoder/kernels/intra.py``.

The reconstruction-side predictors, shared bit-exactly by the encoder's
commit pass and the decoder: DC, V, H, SMOOTH/SMOOTH_V/SMOOTH_H, PAETH
and the directional D45/D67/D135/D157 of the v2 alphabet, vectorized
over a batch of blocks with integer arithmetic only.  The mode decision
evaluates every mode for every block, then argmins.

Neighbor convention: each block sees ``above_ext`` (2N pixels: above and
the above-right run), ``left`` (N pixels) and ``corner`` (1 pixel) from
the reconstructed frame; out-of-frame neighbors are filled by the
caller.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Mode enum (bitstream order of the syntax)
DC_PRED = 0
V_PRED = 1
H_PRED = 2
SMOOTH_PRED = 3
SMOOTH_V_PRED = 4
SMOOTH_H_PRED = 5
PAETH_PRED = 6
N_INTRA_MODES = 7
D45_PRED = 7      # from the above(+right) diagonal, 45°
D67_PRED = 8      # steeper from above
D135_PRED = 9     # from the corner diagonal (above + left)
D157_PRED = 10    # shallower from the left
N_INTRA_MODES_V2 = 11


@functools.lru_cache(maxsize=None)
def smooth_weights(n: int) -> np.ndarray:
    """Normative quadratic blend weights: w[0]=255 .. w[n-1]=16."""
    i = np.arange(n, dtype=np.float64)
    w = np.round(16 + 239.0 * ((n - 1 - i) / max(1, n - 1)) ** 2)
    return w.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _dir_tables(n: int):
    """Static gather tables for the directional predictors (numpy)."""
    y, x = np.mgrid[0:n, 0:n]
    t = {}
    # D45: pred = smooth(a[x+y+1]) over the extended above row (len 2n)
    t["d45"] = np.minimum(x + y + 1, 2 * n - 1)
    # D67: pred = a[x + ceil((y+1)/2)]
    t["d67"] = np.minimum(x + ((y + 2) >> 1), 2 * n - 1)
    # D135: d = x - y; d>0 → a[d-1], d<0 → l[-d-1], d==0 → corner
    d = x - y
    t["d135_a"] = np.clip(d - 1, 0, n - 1)
    t["d135_l"] = np.clip(-d - 1, 0, n - 1)
    t["d135_sel"] = np.sign(d)  # -1 left, 0 corner, +1 above
    # D157: pred = l[y + ceil((x+1)/2)] with below-left clamped
    t["d157"] = np.minimum(y + ((x + 2) >> 1), n - 1)
    return t


_tables: dict = {}


def _dev_tables(n: int, device) -> dict:
    key = (n, str(device))
    t = _tables.get(key)
    if t is None:
        t = {k: torch.as_tensor(v.reshape(-1), dtype=torch.int64,
                                device=device)
             for k, v in _dir_tables(n).items()}
        t["w"] = torch.as_tensor(smooth_weights(n), dtype=torch.int32,
                                 device=device)
        _tables[key] = t
    return t


def _smooth3(p: torch.Tensor) -> torch.Tensor:
    """(p[i-1] + 2 p[i] + p[i+1] + 2) >> 2 with the ends replicated."""
    q = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
    return (q[:, :-2] + 2 * q[:, 1:-1] + q[:, 2:] + 2) >> 2


def predict_all_modes_v2(above_ext: torch.Tensor, left: torch.Tensor,
                         corner: torch.Tensor, n: int) -> torch.Tensor:
    """All 11 modes: above_ext (B, 2N), left (B, N), corner (B,) →
    (B, 11, N, N) int32."""
    B = above_ext.shape[0]
    a = above_ext.to(torch.int32)
    l = left.to(torch.int32)
    c = corner.to(torch.int32)
    tb = _dev_tables(n, a.device)
    an = a[:, :n]
    shp = (B, n, n)

    dc = (an.sum(1, dtype=torch.int32) + l.sum(1, dtype=torch.int32)
          + n) >> int(np.log2(2 * n))
    dc_pred = dc[:, None, None].expand(shp)
    v_pred = an[:, None, :].expand(shp)
    h_pred = l[:, :, None].expand(shp)

    w = tb["w"]
    wy = w[None, :, None]
    wx = w[None, None, :]
    bottom = l[:, n - 1][:, None, None]
    right = an[:, n - 1][:, None, None]
    av = an[:, None, :]
    lv = l[:, :, None]
    smooth = (wy * av + (256 - wy) * bottom
              + wx * lv + (256 - wx) * right + 256) >> 9
    smooth_v = ((wy * av + (256 - wy) * bottom + 128) >> 8).expand(shp)
    smooth_h = ((wx * lv + (256 - wx) * right + 128) >> 8).expand(shp)

    cc = c[:, None, None]
    base = lv + av - cc
    pl = (base - lv).abs()
    pa = (base - av).abs()
    pc = (base - cc).abs()
    paeth = torch.where((pl <= pa) & (pl <= pc), lv.expand(shp),
                        torch.where(pa <= pc, av.expand(shp),
                                    cc.expand(shp)))

    a_smooth = _smooth3(a)
    l_smooth = _smooth3(l)
    d45 = a_smooth[:, tb["d45"]].reshape(shp)
    d67 = a_smooth[:, tb["d67"]].reshape(shp)
    d135_a = a_smooth[:, tb["d135_a"]].reshape(shp)
    d135_l = l_smooth[:, tb["d135_l"]].reshape(shp)
    sel = tb["d135_sel"].reshape(1, n, n)
    d135 = torch.where(sel > 0, d135_a, torch.where(sel < 0, d135_l, cc))
    d157 = l_smooth[:, tb["d157"]].reshape(shp)
    return torch.stack([dc_pred, v_pred, h_pred, smooth, smooth_v, smooth_h,
                        paeth, d45, d67, d135, d157], dim=1)


def predict_mode_v2(above_ext: torch.Tensor, left: torch.Tensor,
                    corner: torch.Tensor, mode: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Per-block selected-mode prediction: modes (B,) → (B, N, N)."""
    allp = predict_all_modes_v2(above_ext, left, corner, n)
    idx = mode.to(torch.int64)[:, None, None, None].expand(-1, 1, n, n)
    return torch.gather(allp, 1, idx)[:, 0]
