"""K1: per-block window gather (port of pallas_gather.gather_windows
and of its two-plane forms gather_windows_wide / gather_windows_ref2).

The inter encoder reads a (W, W) window at an arbitrary per-block
origin out of a padded reference plane several times per frame:
full-pel refine regions (W = n + 16), quarter-pel windows (W = n + 9)
and chroma MC taps (W = size + 7).

Kernel: ``csrc/gather.cu``, replacing the Pallas kernel
``av1tpu/encoder/kernels/pallas_gather.py::_gather_kernel``.  Pure data
movement, bound by bytes: several windows per CTA written as one
contiguous run with 16-byte stores.  One kernel serves both wrappers.

Both wrappers take one plane, or a tuple of planes of one shape and
dtype (U and V) whose windows at the same origins go out in one launch
as a (P, B, W, W) output.  ``gather_windows2`` reads each block's
window from one of two references (LAST, GOLDEN) chosen by a per-block
selector.  The reference builds a column-concatenated float32 copy of
the pair per frame (``make_wide2``) to keep its kernel 2-D; the CUDA
entry takes the base pointers, so the port has no such copy.

The plain versions below are the same gathers as one advanced-indexing
op each; the wrappers use them for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from av1tpu_torch import device as D


def _as_planes(planes):
    """(tuple of planes, whether one bare plane was given)."""
    if isinstance(planes, torch.Tensor):
        return (planes,), True
    return tuple(planes), False


def _origins(hp, wp, oy, ox, W):
    y0 = oy.long().clamp(0, hp - W)
    x0 = ox.long().clamp(0, wp - W)
    ar = torch.arange(W, device=oy.device)
    return ((y0[:, None] + ar[None, :])[:, :, None],
            (x0[:, None] + ar[None, :])[:, None, :])


def gather_windows_plain(planes, oy: torch.Tensor, ox: torch.Tensor,
                         W: int) -> torch.Tensor:
    """(B, W, W) int32 windows of ``planes`` at origins (oy, ox), clamped
    into the plane like ``jax.lax.dynamic_slice``; (P, B, W, W) for a
    tuple of P planes."""
    ps, bare = _as_planes(planes)
    rows, cols = _origins(*ps[0].shape, oy, ox, W)
    out = torch.stack([p[rows, cols] for p in ps]).to(torch.int32)
    return out[0] if bare else out


def gather_windows2_plain(p0, p1, ri: torch.Tensor, oy: torch.Tensor,
                          ox: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W, W) int32 windows at origins (oy, ox) of reference ``ri`` of
    the pair (p0, p1); origins clamped into a single plane, ``ri`` into
    {0, 1}.  With tuples of P planes each, (P, B, W, W)."""
    last, bare = _as_planes(p0)
    gold, _ = _as_planes(p1)
    rows, cols = _origins(*last[0].shape, oy, ox, W)
    sel = ri.long().clamp(0, 1)[:, None, None]
    out = torch.stack([torch.stack([a, b])[sel, rows, cols]
                       for a, b in zip(last, gold)]).to(torch.int32)
    return out[0] if bare else out


def _launch(planes, ri, oy, ox, W: int, P: int, name: str) -> torch.Tensor:
    """Check every tensor, then launch the kernel into a (P, B, W, W)
    output.  ``planes`` holds P planes, or 2P (LAST ones, then GOLDEN
    ones) with a selector ``ri``."""
    p0 = planes[0]
    if p0.dtype not in (torch.int16, torch.int32) or \
            any(p.dtype != p0.dtype for p in planes):
        raise TypeError(f"{name}: plane dtypes "
                        f"{sorted({str(p.dtype) for p in planes})} (need "
                        "all int16 or all int32)")
    idx = (oy, ox) if ri is None else (ri, oy, ox)
    if p0.dim() != 2 or any(p.shape != p0.shape for p in planes) or \
            oy.dim() != 1 or any(t.shape != oy.shape for t in idx) or \
            P not in (1, 2):
        raise ValueError(f"{name}: {P} output planes, planes "
                         f"{[tuple(p.shape) for p in planes]}, indices "
                         f"{[tuple(t.shape) for t in idx]}")
    if any(t.device != p0.device for t in (*planes, *idx)):
        raise ValueError(f"{name}: planes, selector and origins on "
                         "different devices")
    hp, wp = p0.shape
    if W < 1 or W > hp or W > wp:
        raise ValueError(f"{name}: W={W} for planes {hp}x{wp}")
    planes = [p.contiguous() for p in planes]
    idx = [t.to(torch.int32).contiguous() for t in idx]
    B = oy.shape[0]
    out = torch.empty((P, B, W, W), dtype=torch.int32, device=p0.device)
    vp = ctypes.c_void_p
    ptrs = [vp(p.data_ptr()) for p in planes] + [None] * (4 - len(planes))
    ri_p = None if ri is None else vp(idx[0].data_ptr())
    # the launch goes to the planes' card and its current stream, whichever
    # card is current on this thread
    with torch.cuda.device(p0.device):
        err = D.kernels().av1_gather_windows(
            *ptrs, P, 0 if p0.dtype == torch.int16 else 1, hp, wp, ri_p,
            vp(idx[-2].data_ptr()), vp(idx[-1].data_ptr()), B, W,
            vp(out.data_ptr()), vp(D.stream_ptr(p0.device)))
    D.check_launch(err, name)
    return out


def gather_windows(planes, oy: torch.Tensor, ox: torch.Tensor,
                   W: int) -> torch.Tensor:
    """Gather (B, W, W) int32 windows at rows oy / cols ox.

    planes: a 2-D integer plane (int16 or int32 on CUDA), or a tuple of
    one or two such planes of one shape and dtype, which gives
    (P, B, W, W) in one launch; oy/ox (B,) window origins, already
    clamped to [0, Hp-W] x [0, Wp-W] by the caller.  CUDA tensors launch
    the kernel; CPU tensors take the plain version.
    """
    ps, bare = _as_planes(planes)
    dev = ps[0].device.type
    if dev == "cuda":
        out = _launch(ps, None, oy, ox, W, len(ps), "gather_windows")
        gather_windows.launches += 1
        return out[0] if bare else out
    if dev == "cpu":
        return gather_windows_plain(planes, oy, ox, W)
    raise RuntimeError(f"gather_windows: unsupported device {dev}")


gather_windows.launches = 0


def gather_windows2(p0, p1, ri: torch.Tensor, oy: torch.Tensor,
                    ox: torch.Tensor, W: int) -> torch.Tensor:
    """Gather (B, W, W) int32 windows, block b from reference ``ri[b]``
    of (p0, p1) at rows oy / cols ox.

    p0, p1: the LAST and GOLDEN planes, one shape and dtype (int16 or
    int32 on CUDA), or tuples of one or two planes each (U and V), which
    give (P, B, W, W) in one launch; ri (B,) in {0, 1}; oy/ox (B,)
    origins clamped to [0, Hp-W] x [0, Wp-W] of a single plane by the
    caller.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.
    """
    last, bare = _as_planes(p0)
    gold, _ = _as_planes(p1)
    dev = last[0].device.type
    if dev == "cuda":
        if len(gold) != len(last):
            raise ValueError(f"gather_windows2: {len(last)} LAST planes, "
                             f"{len(gold)} GOLDEN")
        out = _launch(last + gold, ri, oy, ox, W, len(last),
                      "gather_windows2")
        gather_windows2.launches += 1
        return out[0] if bare else out
    if dev == "cpu":
        return gather_windows2_plain(p0, p1, ri, oy, ox, W)
    raise RuntimeError(f"gather_windows2: unsupported device {dev}")


gather_windows2.launches = 0
