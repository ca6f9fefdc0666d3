"""K1: per-block window gather (port of pallas_gather.gather_windows).

The inter encoder reads a (W, W) window at an arbitrary per-block
origin out of a padded reference plane several times per frame:
full-pel refine regions (W = n + 16), quarter-pel windows (W = n + 9)
and chroma MC taps (W = size + 7).

Kernel: ``csrc/gather.cu``, replacing the Pallas kernel
``av1tpu/encoder/kernels/pallas_gather.py::_gather_kernel``.  Pure data
movement, bound by bytes; one CTA per block with coalesced row reads.
The plain version below is the same gather as one advanced-indexing
op; the wrapper uses it for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from av1tpu_torch import device as D


def gather_windows_plain(plane: torch.Tensor, oy: torch.Tensor,
                         ox: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W, W) int32 windows of ``plane`` at origins (oy, ox), clamped
    into the plane like ``jax.lax.dynamic_slice``."""
    hp, wp = plane.shape
    y0 = oy.long().clamp(0, hp - W)
    x0 = ox.long().clamp(0, wp - W)
    ar = torch.arange(W, device=plane.device)
    rows = (y0[:, None] + ar[None, :])[:, :, None]
    cols = (x0[:, None] + ar[None, :])[:, None, :]
    return plane[rows, cols].to(torch.int32)


def _gather_cuda(plane, oy, ox, W):
    if plane.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"gather_windows: plane dtype {plane.dtype} "
                        "(need int16 or int32)")
    if plane.dim() != 2 or oy.dim() != 1 or oy.shape != ox.shape:
        raise ValueError(f"gather_windows: plane {tuple(plane.shape)}, "
                         f"oy {tuple(oy.shape)}, ox {tuple(ox.shape)}")
    if oy.device != plane.device or ox.device != plane.device:
        raise ValueError("gather_windows: plane and origins on different "
                         "devices")
    plane = plane.contiguous()
    oy = oy.to(torch.int32).contiguous()
    ox = ox.to(torch.int32).contiguous()
    B = oy.shape[0]
    hp, wp = plane.shape
    if W > hp or W > wp:
        raise ValueError(f"gather_windows: W={W} exceeds plane {hp}x{wp}")
    out = torch.empty((B, W, W), dtype=torch.int32, device=plane.device)
    vp = ctypes.c_void_p
    err = D.kernels().av1_gather_windows(
        vp(plane.data_ptr()), 0 if plane.dtype == torch.int16 else 1,
        hp, wp, vp(oy.data_ptr()), vp(ox.data_ptr()), B, W,
        vp(out.data_ptr()), vp(D.stream_ptr()))
    D.check_launch(err, "gather_windows")
    gather_windows.launches += 1
    return out


def gather_windows(plane: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   W: int) -> torch.Tensor:
    """Gather (B, W, W) int32 windows at rows oy / cols ox.

    plane: 2-D integer plane (int16 or int32 on CUDA); oy/ox (B,) window
    origins, already clamped to [0, Hp-W] x [0, Wp-W] by the caller.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if plane.device.type == "cuda":
        return _gather_cuda(plane, oy, ox, W)
    if plane.device.type == "cpu":
        return gather_windows_plain(plane, oy, ox, W)
    raise RuntimeError(f"gather_windows: unsupported device {plane.device}")


gather_windows.launches = 0
