# Frozen copy of chip_smoke.py's bound arithmetic (HBM_BYTES_PER_S, INT8_OPS_PER_S, bound_ms, touched_bytes and K2's count), taking shapes in place of planes.
"""The least time the card could take for one K1 or K2 launch.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
HBM3 bytes/s and the int8 tensor-core rate, the highest integer rate of
the card.  A launch's bound is the larger of its bytes over the HBM rate
and its operations over the int8 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound_s(nbytes: int, ops: int = 0) -> float:
    """Bytes over the HBM rate or operations over the int8 peak, whichever
    is larger, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)


def touched_bytes(shape, elsize: int, P: int, ri, oy, ox, W: int) -> int:
    """The bytes a K1 launch needs: the plane elements some window covers
    (per reference where a selector ri is given, whose LAST and GOLDEN
    planes are P each), each read once, the index vectors and the output.
    shape: one plane's (rows, cols); elsize: its element bytes."""
    import torch
    hp, wp = shape
    ar = torch.arange(W, device=oy.device)
    sel = torch.zeros_like(oy) if ri is None else ri.clamp(0, 1)
    touched = torch.zeros((2, hp, wp), dtype=torch.bool, device=oy.device)
    touched[sel.long()[:, None, None], (oy.long()[:, None] + ar)[:, :, None],
            (ox.long()[:, None] + ar)[:, None, :]] = True
    B = oy.shape[0]
    return (P * int(touched.sum()) * elsize
            + 4 * B * (2 if ri is None else 3) + 4 * P * B * W * W)


def k2_bytes_ops(B: int, n: int, radius: int) -> tuple:
    """K2's bytes (int32 blocks and regions read once, the SSD and the
    displacement written) and operations (a subtract, a multiply and an
    add a sample for each of the (2r + 1)^2 displacements)."""
    R = n + 2 * radius
    return (4 * B * (n * n + R * R) + 12 * B,
            3 * (2 * radius + 1) ** 2 * n * n * B)
