"""K1: per-block window gather (port of pallas_gather.gather_windows
and of its two-plane forms gather_windows_wide / gather_windows_ref2).

The inter encoder reads a (W, W) window at an arbitrary per-block
origin out of a padded reference plane several times per frame:
full-pel refine regions (W = n + 16), quarter-pel windows (W = n + 9)
and chroma MC taps (W = size + 7).

Kernel: ``csrc/gather.cu``, replacing the Pallas kernel
``av1tpu/encoder/kernels/pallas_gather.py::_gather_kernel``.  Pure data
movement, bound by bytes; one CTA per block with coalesced row reads.
The plain versions below are the same gathers as one advanced-indexing
op each; the wrappers use them for CPU tensors only.

``gather_windows2`` reads each block's window from one of two planes
(LAST, GOLDEN) chosen by a per-block selector.  The reference builds a
column-concatenated float32 copy of the pair per frame (``make_wide2``)
to keep its kernel 2-D; the CUDA entry takes both base pointers, so the
port has no such copy and no handle to pass around.
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


def gather_windows2_plain(p0: torch.Tensor, p1: torch.Tensor,
                          ri: torch.Tensor, oy: torch.Tensor,
                          ox: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W, W) int32 windows at origins (oy, ox) of plane ``ri`` of the
    pair (p0, p1); origins clamped into a single plane, ``ri`` into
    {0, 1}."""
    hp, wp = p0.shape
    y0 = oy.long().clamp(0, hp - W)
    x0 = ox.long().clamp(0, wp - W)
    ar = torch.arange(W, device=p0.device)
    rows = (y0[:, None] + ar[None, :])[:, :, None]
    cols = (x0[:, None] + ar[None, :])[:, None, :]
    sel = ri.long().clamp(0, 1)[:, None, None]
    return torch.stack([p0, p1])[sel, rows, cols].to(torch.int32)


def _gather2_cuda(p0, p1, ri, oy, ox, W):
    if p0.dtype not in (torch.int16, torch.int32) or p1.dtype != p0.dtype:
        raise TypeError(f"gather_windows2: plane dtypes {p0.dtype}, "
                        f"{p1.dtype} (need both int16 or both int32)")
    if p0.dim() != 2 or p1.shape != p0.shape or oy.dim() != 1 or \
            oy.shape != ox.shape or ri.shape != oy.shape:
        raise ValueError(f"gather_windows2: planes {tuple(p0.shape)}, "
                         f"{tuple(p1.shape)}, ri {tuple(ri.shape)}, oy "
                         f"{tuple(oy.shape)}, ox {tuple(ox.shape)}")
    if any(t.device != p0.device for t in (p1, ri, oy, ox)):
        raise ValueError("gather_windows2: planes, selector and origins on "
                         "different devices")
    hp, wp = p0.shape
    if W > hp or W > wp:
        raise ValueError(f"gather_windows2: W={W} exceeds plane {hp}x{wp}")
    p0 = p0.contiguous()
    p1 = p1.contiguous()
    ri, oy, ox = (t.to(torch.int32).contiguous() for t in (ri, oy, ox))
    B = oy.shape[0]
    out = torch.empty((B, W, W), dtype=torch.int32, device=p0.device)
    vp = ctypes.c_void_p
    err = D.kernels().av1_gather_windows2(
        vp(p0.data_ptr()), vp(p1.data_ptr()),
        0 if p0.dtype == torch.int16 else 1, hp, wp, vp(ri.data_ptr()),
        vp(oy.data_ptr()), vp(ox.data_ptr()), B, W, vp(out.data_ptr()),
        vp(D.stream_ptr()))
    D.check_launch(err, "gather_windows2")
    gather_windows2.launches += 1
    return out


def gather_windows2(p0: torch.Tensor, p1: torch.Tensor, ri: torch.Tensor,
                    oy: torch.Tensor, ox: torch.Tensor,
                    W: int) -> torch.Tensor:
    """Gather (B, W, W) int32 windows, block b from plane ``ri[b]`` of
    (p0, p1) at rows oy / cols ox.

    p0, p1: 2-D planes of one shape and dtype (int16 or int32 on CUDA);
    ri (B,) in {0, 1}; oy/ox (B,) origins clamped to [0, Hp-W] x
    [0, Wp-W] of a single plane by the caller.  CUDA tensors launch the
    kernel; CPU tensors take the plain version.
    """
    if p0.device.type == "cuda":
        return _gather2_cuda(p0, p1, ri, oy, ox, W)
    if p0.device.type == "cpu":
        return gather_windows2_plain(p0, p1, ri, oy, ox, W)
    raise RuntimeError(f"gather_windows2: unsupported device {p0.device}")


gather_windows2.launches = 0
