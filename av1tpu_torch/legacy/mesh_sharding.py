"""Tile-row stripes of the private av1tpu profile: a port of
``av1tpu/legacy/mesh_sharding.py``.

Each stripe of a stripe group (``specav1/stripes.py``: an ordered tuple
of ``torch.device``s of one process, one a stripe, repeats allowed, or
``Ranks``, one stripe a rank of a ``torch.distributed`` process group)
encodes one horizontal stripe of the frame.  The reference runs one
``shard_map`` program over a ("rows",) mesh; here one thread issues the
stripes of a one-process group in order, each under its own device, and
each rank its own stripe, and the outputs are gathered in stripe order
(stripe-major is raster order) to the group's first device, or to every
rank.

* P-frames read the previous reconstruction through a padded window
  per stripe (``stripes.halo_windows`` at the plane's true height and
  width: ``pad`` boundary rows from each vertical neighbour, copied or
  all-gathered between ranks, the frame's edge rows replicated at its top
  and bottom, the columns edge-padded), which is the reference's
  ``ppermute`` halo exchange, so motion is unrestricted across stripe
  edges within +-MAX_MV < PAD.
* Keyframes need no halo: intra prediction never crosses tile rows, so
  each stripe runs its own wavefront (one tile).
* The v2 functions filter each stripe on its own (deblock, CDEF, loop
  restoration), with the CDEF gate and the restoration mode decided for
  the whole frame: each stripe's squared-error sums on the [::4, ::4]
  grid are added up (the reference's ``psum``: on the first device, an
  ``all_reduce`` between ranks).  The sums are exact integers; the
  reference's float32 sums agree while they stay below 2^24.

Each function equals the one-device encode with ``tile_rows`` = the
stripe count.  The recon planes come back as uint8 at 8 bits and int16
at 10 bits (the reference's uint16).  Under the process group of
``encoder/mesh/distributed.py`` (the reference's ``jax.distributed``)
``make_mesh`` gives the group of every rank, one card a rank.
"""

from __future__ import annotations

import torch

from av1tpu_torch.encoder.kernels import cdef, deblock, mc, motion
from av1tpu_torch.encoder.kernels import restoration
from av1tpu_torch.encoder.mesh import distributed
from av1tpu_torch.legacy.core import inter_frame as IF
from av1tpu_torch.legacy.core import intra_frame as KF
from av1tpu_torch.specav1.stripes import (Ranks, gather_rows, halo_windows,
                                          local, on_device, shard_rows,
                                          sum_stripes)


def make_mesh(n_devices: int = 0, device: str = "cuda") -> tuple:
    """The stripe group of ``n_devices`` devices: on ``"cuda"`` the first
    n visible cards (0: every visible card; more than are visible raises
    ValueError), on ``"cpu"`` the CPU repeated (0: once).  Under a process
    group, every rank, each on its own device (0 or the world size; any
    other count raises ValueError)."""
    if distributed.active():
        world = distributed.world_size()
        if n_devices not in (0, world):
            raise ValueError(f"requested {n_devices} devices under a "
                             f"process group of {world} ranks")
        return Ranks(distributed.rank_device(device), world,
                     distributed.rank())
    dev = torch.device(device)
    if dev.type == "cpu":
        return (dev,) * max(n_devices, 1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices <= 0:
        n_devices = have
    if n_devices > have or n_devices == 0:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    return tuple(torch.device("cuda", i) for i in range(n_devices))


def _check_rows(h: int, n_dev: int, block: int) -> None:
    if h % (n_dev * block):
        raise ValueError(f"luma height {h} not divisible by "
                         f"n_devices*block = {n_dev * block}")


def _ref_windows(group, parts3, k: int, row0: int, h: int, w: int):
    """Stripe k's padded Y, U and V reference windows (the reference's
    ``_exchange_ref_halos``)."""
    c = (motion.CHROMA_PAD, h // 2, w // 2, row0 // 2)
    return halo_windows(group, parts3, k, [(motion.PAD, h, w, row0), c, c])


def encode_inter_frame_sharded(y, u, v, ref_y, ref_u, ref_v, dc_step,
                               ac_step, block: int, mesh):
    """Striped v1 P-frame: global (unpadded) source and reference planes
    in; the luma height must be a multiple of n_devices * block and each
    stripe must span at least PAD luma and CHROMA_PAD chroma rows (the
    halo comes from one neighbour).  Returns
    ``inter_frame.encode_inter_frame``'s 7-tuple over the whole frame
    (stripe-major, which is raster order) on the group's first device,
    and the total count of nonzero levels (an int32 scalar there)."""
    group = mesh
    n_dev = len(group)
    h, w = y.shape
    _check_rows(h, n_dev, block)
    stripe = h // n_dev
    if stripe < motion.PAD:
        raise ValueError(
            f"stripe height {stripe} < halo depth {motion.PAD}; "
            f"use fewer devices or taller frames")
    if (h // 2) % n_dev or (h // 2 // n_dev) < motion.CHROMA_PAD:
        raise ValueError("chroma stripes too short for halo exchange")
    src = [shard_rows(group, p) for p in (y, u, v)]
    refs = [shard_rows(group, p.to(torch.int32)) for p in (ref_y, ref_u,
                                                          ref_v)]
    outs, nz = [], []
    for k, d in local(group):
        with on_device(d):
            out = IF.encode_inter_frame(
                src[0][k], src[1][k], src[2][k],
                *_ref_windows(group, refs, k, k * stripe, h, w), dc_step,
                ac_step, block)
            nz.append(sum((lv != 0).sum(dtype=torch.int32)
                          for lv in out[1:4]))
        outs.append(out)
    return tuple(gather_rows(group, outs, range(7))) + (
        sum_stripes(group, nz),)


def _stripe_filters(rec_y, rec_u, rec_v, src_y, n: int, qindex: int,
                    bit_depth: int) -> dict:
    """One stripe's deblocked planes, their CDEF candidates and its part
    of the CDEF gate's squared errors."""
    out_y = deblock.deblock_plane(rec_y, n, qindex, bit_depth)
    out_uv = deblock.deblock_plane(torch.stack([rec_u, rec_v]), n // 2,
                                   qindex, bit_depth)
    cdef_y = cdef.cdef_plane(out_y, qindex, bit_depth)
    return {"y": out_y, "uv": out_uv, "cdef_y": cdef_y,
            "cdef_uv": cdef.cdef_plane(out_uv, qindex, bit_depth,
                                       is_chroma=True),
            "src": src_y, "e": cdef.gate_errors(src_y, out_y, cdef_y)}


def _frame_gates(group, stripes: list, bit_depth: int):
    """The frame's CDEF gate and restoration mode from every stripe's
    partial sums (``sum_stripes``), then the final planes of this
    process's stripes.  Returns ([(y, u, v)] per stripe in the output
    dtype, lr_mode int, cdef_on bool tensor on the first device)."""
    maxval = (1 << bit_depth) - 1
    e = sum_stripes(group, [s["e"] for s in stripes])
    cdef_on = e[1] < e[0]
    costs = []
    for (_, d), s in zip(local(group), stripes):
        with on_device(d):
            on = cdef_on.to(d)
            s["y"] = cdef.select(on, s["cdef_y"], s["y"])
            s["uv"] = cdef.select(on, s["cdef_uv"], s["uv"])
            costs.append(restoration.mode_costs(s["src"], s["y"], maxval))
    total = sum_stripes(group, costs).tolist()
    lr_mode = total.index(min(total))
    out_dtype = torch.uint8 if bit_depth == 8 else torch.int16
    planes = []
    for (_, d), s in zip(local(group), stripes):
        with on_device(d):
            oy = restoration.apply_restoration(s["y"], lr_mode, maxval)
            ouv = restoration.apply_restoration(s["uv"], lr_mode, maxval)
            planes.append(tuple(p.to(out_dtype) for p in (oy, ouv[0],
                                                          ouv[1])))
    return planes, lr_mode, cdef_on


def _gather_outputs(group, rows: list, planes: list):
    """Per-stripe block outputs and final planes gathered in stripe order
    (``gather_rows``, one exchange for all of them)."""
    nb = len(rows[0])
    out = gather_rows(group, [r + p for r, p in zip(rows, planes)],
                      range(nb + 3))
    return out[:nb], out[nb:]


def _skips(lv_y, lv_u, lv_v):
    return (lv_y == 0).all(1) & (lv_u == 0).all(1) & (lv_v == 0).all(1)


def encode_inter_frame_sharded_v2(y_u8, u_u8, v_u8, ref_y_u8, ref_u_u8,
                                  ref_v_u8, dc_step, ac_step, qindex: int,
                                  block: int, mesh, bit_depth: int = 8):
    """Striped v2 P-frame: each stripe is one tile (search_v3, subpel
    refine and MC, transform selection, deblock, CDEF), the CDEF gate
    and restoration mode frame-global.  Unpadded source and reference
    planes in.  Returns (mvs int16, levels y / u / v int16, skips, recon
    y / u / v, lr_mode int, cdef_on, tx_syms uint8): the one-device
    ``encode_inter_frame_v2(..., tile_rows=n)`` outputs minus the sparse
    pack, in its order."""
    group = mesh
    n_dev = len(group)
    h, w = y_u8.shape
    _check_rows(h, n_dev, block)
    if h // n_dev < motion.PAD or (h // 2 // n_dev) < motion.CHROMA_PAD:
        raise ValueError("stripes too short for halo exchange")
    n = block
    cn = n // 2
    maxval = (1 << bit_depth) - 1
    sh = h // n_dev
    src = [shard_rows(group, p) for p in (y_u8, u_u8, v_u8)]
    refs = [shard_rows(group, p.to(torch.int32)) for p in (ref_y_u8,
                                                          ref_u_u8,
                                                          ref_v_u8)]
    rows, stripes = [], []
    for k, d in local(group):
        with on_device(d):
            ry, ru, rv = _ref_windows(group, refs, k, k * sh, h, w)
            y, u, v = (p[k].to(torch.int32) for p in src)
            hp, wp = y.shape
            hc, wc = u.shape
            pos_y = IF.block_positions(hp, wp, n, d)
            y_blocks = motion._to_blocks(y, n)
            mvs = motion.subpel_refine(y_blocks, ry, pos_y,
                                       motion.search_v3(y, ry, n), n,
                                       maxval=maxval)
            pred_y = mc.predict_subpel_luma(ry, pos_y, mvs, n, motion.PAD,
                                            maxval)
            lv_y, rec_y, tx_syms = IF._code_plane_txsel(
                y_blocks, pred_y, dc_step, ac_step, maxval,
                IF.tx_lambda(ac_step))
            pos_c = IF.block_positions(hc, wc, cn, d)
            lv_c, rec_c = [], []
            for ref, plane in ((ru, u), (rv, v)):
                pred = mc.predict_subpel_chroma(ref, pos_c, mvs, cn,
                                                motion.CHROMA_PAD, maxval)
                lv, rec = IF._code_plane(motion._to_blocks(plane, cn), pred,
                                         dc_step, ac_step, maxval)
                lv_c.append(lv.reshape(lv.shape[0], -1))
                rec_c.append(IF._from_blocks(rec, hc, wc, cn))
            lv_y = lv_y.reshape(lv_y.shape[0], -1)
            rows.append((mvs.to(torch.int16), lv_y.to(torch.int16),
                         lv_c[0].to(torch.int16), lv_c[1].to(torch.int16),
                         _skips(lv_y, *lv_c), tx_syms))
            stripes.append(_stripe_filters(IF._from_blocks(rec_y, hp, wp, n),
                                           rec_c[0], rec_c[1], y, n, qindex,
                                           bit_depth))
    planes, lr_mode, cdef_on = _frame_gates(group, stripes, bit_depth)
    (mvs, lv_y, lv_u, lv_v, skips, tx_syms), recon = _gather_outputs(
        group, rows, planes)
    return (mvs, lv_y, lv_u, lv_v, skips, *recon, lr_mode, cdef_on, tx_syms)


def encode_key_frame_sharded_v2(y_u8, u_u8, v_u8, dc_step, ac_step,
                                qindex: int, block: int, mesh,
                                bit_depth: int = 8):
    """Striped v2 keyframe: each stripe runs its own intra wavefront (one
    tile; no halo), its own filters, and the frame-global gates.
    Returns (y_modes uint8, levels y / u / v int16, skips, recon y / u /
    v, lr_mode int, cdef_on, uv_modes uint8): the one-device
    ``encode_key_frame_v2(..., tile_rows=n)`` outputs minus the sparse
    pack, in its order."""
    group = mesh
    h = y_u8.shape[0]
    _check_rows(h, len(group), block)
    n = block
    cn = n // 2
    src = [shard_rows(group, p) for p in (y_u8, u_u8, v_u8)]
    rows, stripes = [], []
    for k, d in local(group):
        with on_device(d):
            y = src[0][k].to(torch.int32)[None]
            uv = torch.stack([src[1][k], src[2][k]]).to(torch.int32)
            modes = KF.decide_modes(y, n, bit_depth)            # (1, B)
            uv_modes = KF.decide_uv_modes(uv[:1], uv[1:], cn, bit_depth)
            # one tile: the forward transform sums as the stripe's own
            # wavefront lanes do (tiles=1)
            lv_y, rec_y = KF._commit(y, None, modes, dc_step, ac_step, n,
                                     decode=False, bit_depth=bit_depth)
            lv_uv, rec_uv = KF._commit(uv, None, uv_modes.repeat(2, 1),
                                       dc_step, ac_step, cn, decode=False,
                                       bit_depth=bit_depth)
            rows.append((modes[0].to(torch.uint8), lv_y[0].to(torch.int16),
                         lv_uv[0].to(torch.int16), lv_uv[1].to(torch.int16),
                         _skips(lv_y[0], lv_uv[0], lv_uv[1]),
                         uv_modes[0].to(torch.uint8)))
            stripes.append(_stripe_filters(rec_y[0], rec_uv[0], rec_uv[1],
                                           y[0], n, qindex, bit_depth))
    planes, lr_mode, cdef_on = _frame_gates(group, stripes, bit_depth)
    (modes, lv_y, lv_u, lv_v, skips, uv_modes), recon = _gather_outputs(
        group, rows, planes)
    return (modes, lv_y, lv_u, lv_v, skips, *recon, lr_mode, cdef_on,
            uv_modes)
