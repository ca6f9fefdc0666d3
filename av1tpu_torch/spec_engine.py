"""Spec-AV1 engine of the PyTorch port: ``SpecTorchEngine``.

The port of ``av1tpu/spec_engine.py``'s single-device, single-frame
pipeline: keyframes from ``specav1.torch_intra``, P-frames from
``specav1.torch_inter``, sparse level packing on the device, and the
port's own native C++ tile writer plus header/OBU writer on the host.  The
output is standard AV1 in the same low-overhead framing as the JAX
engine (keyframes carry [sequence header OBU][frame OBU]).

Supported configuration: the daemon's default except chunking and
multiple devices: ``chunk=1``, one device, 8- or 10-bit, ``golden``,
``cdef`` and ``lr`` each on or off.  With ``golden`` the GOP keyframe's
filtered reconstruction stays in reference slot 1 and every P-frame
block picks LAST or GOLDEN.  Deblocking is decided per GOP exactly as
the JAX engine does: on for a clean source (noise floor <= 1) whose
coded height is a multiple of 32, or 16 past one with a width that is a
multiple of 16 (every 720p and 2160p file; never 1080p, where
1080 % 32 == 24), at a level derived from each frame's qindex.  With
``cdef`` every frame carries its searched CDEF strengths (damping from
the qindex), and with ``lr`` the luma plane's per-unit Wiener choices
and taps (frame restoration types (WIENER, NONE, NONE), 256-px units).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from av1tpu_torch import device as D
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.engine import TorchEngine
from av1tpu_torch.specav1 import lr as _NL
from av1tpu_torch.specav1 import native
from av1tpu_torch.specav1 import obu as obu_mod
from av1tpu_torch.specav1 import recon, torch_inter, torch_intra, torch_lr
from av1tpu_torch.specav1 import writer as W

I32 = torch.int32

# sparse level transfer capacity (nonzero coefficients) as a fraction
# of the total coefficient count; on overflow _finalize copies the
# full planes
SPARSE_CAP_FRACTION = 32


# --- host helpers copied from av1tpu/spec_engine.py (a JAX module) ---------

def _axis_true_dims_ok(px: int, is_height: bool = False) -> bool:
    """True when an axis can be coded at its true size on the fixed
    32x32 grid (exact multiples, a >16px overhang, or a 16px height
    strip)."""
    rem = px % 32
    if px % 2:
        return False
    if rem == 0 or rem > 16:
        return True
    return is_height and rem == 16


class SpecSequenceHeader:
    """Sequence parameters for the spec bitstream (av1C + seq OBU)."""

    def __init__(self, width: int, height: int, bit_depth: int = 8,
                 color_primaries: int = 0, color_transfer: int = 0,
                 color_matrix: int = 0, enable_cdef: bool = False,
                 enable_restoration: bool = False):
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.color_primaries = color_primaries
        self.color_transfer = color_transfer
        self.color_matrix = color_matrix
        self.enable_cdef = enable_cdef
        self.enable_restoration = enable_restoration

    def seq_obu(self) -> bytes:
        cp = self.color_primaries or None
        w, h = self.width, self.height
        if not (_axis_true_dims_ok(w) and _axis_true_dims_ok(h, True)):
            w, h = (w + 63) & ~63, (h + 63) & ~63
        return W.write_sequence_header(
            w, h, bit_depth=self.bit_depth,
            color_primaries=cp,
            transfer=self.color_transfer if cp else None,
            matrix=self.color_matrix if cp else None,
            enable_cdef=self.enable_cdef,
            enable_restoration=self.enable_restoration)

    def av1c(self) -> bytes:
        hbd = 1 if self.bit_depth > 8 else 0
        b2 = (hbd << 6) | (1 << 3) | (1 << 2)
        return bytes([0x81, 0, b2, 0x00]) + self.seq_obu()


def noise_floor(y) -> float:
    """Median |horizontal second difference| on a row-subsampled grid:
    grainy sources measure >= 2, smooth/blocky content <= 1."""
    s = np.asarray(y[::8], np.int32)
    d2 = s[:, 2:] - 2 * s[:, 1:-1] + s[:, :-2]
    return float(np.median(np.abs(d2)))


def lf_levels(qindex: int, bit_depth: int = 8) -> tuple:
    """Deblocking filter level (luma, chroma) from qindex (libaom's
    q-based guess: av1_pick_filter_level's filt_guess regression, per
    bit depth; 8 or 10 bits)."""
    q = int(recon.AC_Q[bit_depth][int(qindex)])
    if bit_depth == 8:
        lvl = (q * 20723 + 1015158) >> 18
    elif bit_depth == 10:
        lvl = (q * 20723 + 4060632) >> 20
    else:
        raise ValueError(f"lf_levels: bit depth {bit_depth}")
    lvl = max(0, min(63, lvl))
    return lvl, lvl


def cdef_damping(qindex: int) -> int:
    """CDEF damping from qindex (libaom's pick_cdef heuristic:
    3 + (base_q_idx >> 6), range 3..6)."""
    return min(6, 3 + (int(qindex) >> 6))


def _lr_nru(th: int, tw: int) -> tuple:
    """(unit_rows, unit_cols) of the luma 256px restoration-unit grid."""
    return (_NL.count_units_in_frame(256, th),
            _NL.count_units_in_frame(256, tw))


def _lr_taps():
    """Tied (v == h) 6-tap rows for the static presets."""
    p = np.asarray(torch_lr.PRESETS, np.int32)
    return np.concatenate([p, p], axis=1)


def _lr_table(choice_grid, taps6):
    """(choice_grid', taps_table) for the tile writer: preset rows
    0..P-1 (tied), then one solved (v0,v1,v2,h0,h1,h2) row per RU;
    device choice P (= solved) maps to row P + ru_index."""
    P = len(torch_lr.PRESETS)
    nru = taps6.shape[0]
    tab = np.concatenate([_lr_taps(), np.asarray(taps6, np.int32)],
                         axis=0)
    idx = np.where(choice_grid == P,
                   P + np.arange(nru, dtype=np.int32).reshape(
                       choice_grid.shape),
                   choice_grid)
    return idx.astype(np.int32), tab


def _tile_plan(th: int):
    """(tile_rows_log2, spans, block_row_starts) for a coded height on
    one device."""
    mi_rows = 2 * ((th + 7) >> 3)
    sbr = (mi_rows + 15) >> 4
    trl2 = 2 if sbr >= 8 else 0
    spans = W.tile_row_spans(th, trl2)
    brs = tuple(mi0 // 8 for mi0, _ in spans[1:])
    return trl2, spans, brs


def _unpack_levels(maskbytes, vals, count, shapes):
    """Host inverse of pack_outputs; None when the nonzero count
    overflowed the value capacity."""
    total = sum(h * w for h, w in shapes)
    if int(count) > vals.shape[0]:
        return None
    flat = native.densify(np.asarray(maskbytes), np.asarray(vals), total)
    out = []
    off = 0
    for hh, ww in shapes:
        out.append(flat[off:off + hh * ww].reshape(hh, ww))
        off += hh * ww
    return out


# --- device side -------------------------------------------------------------

_BITS = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=I32)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """numpy.packbits of a flat bool tensor: big-endian bit order within
    each byte, zero-padded to a whole byte (native.densify reads it)."""
    n = mask.shape[0]
    pad = (-n) % 8
    m = mask.to(I32)
    if pad:
        m = torch.cat([m, m.new_zeros(pad)])
    w = _BITS.to(mask.device)
    return (m.reshape(-1, 8) * w).sum(1, dtype=I32).to(torch.uint8)


def pack_outputs(lv_y, lv_u, lv_v, grids, cap: int):
    """Sparse level packing (port of spec_engine._pack_outputs): the
    nonzero mask as packed bits, the nonzero values compacted in
    position order into int16[cap] by a cumsum, their count, and the
    int32 grids."""
    flat = torch.cat([lv_y.reshape(-1), lv_u.reshape(-1), lv_v.reshape(-1)])
    mask = flat != 0
    count = mask.sum(dtype=I32)
    idx = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    # out-of-capacity and zero positions land in a dropped slot
    slot = torch.where(mask, idx, cap).clamp(max=cap).long()
    vals = torch.zeros((cap + 1,), dtype=torch.int16, device=flat.device)
    vals.scatter_(0, slot, flat.clamp(-32768, 32767).to(torch.int16))
    return packbits(mask), vals[:cap], count, grids.to(I32)


def state_from_numpy(ref_y, ref_u, ref_v, device) -> tuple:
    """Reference planes given as numpy arrays (for example another
    encoder's reconstruction) as the port's int32 device tensors: one
    call for the LAST planes, another for the GOLDEN ones."""
    dev = D.resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(p, np.int32)).to(dev)
                 for p in (ref_y, ref_u, ref_v))


def _upload(plane: np.ndarray, dev) -> torch.Tensor:
    # 8-bit planes travel as uint8, 10-bit as int16 (torch's uint16
    # op coverage is thin); the encoders widen to int32 on the device
    dt = np.uint8 if plane.dtype == np.uint8 else np.int16
    return torch.from_numpy(np.ascontiguousarray(plane, dt)).to(dev)


class SpecTorchEngine(TorchEngine):
    """Standard-AV1 engine on PyTorch (see module docstring)."""

    def __init__(self, cfg: Optional[TpuEncoderConfig] = None,
                 device: str = "cuda"):
        super().__init__(cfg)
        self.device = D.resolve_device(device)
        c = self.cfg
        missing = []
        if c.chunk > 1:
            missing.append("chunked dispatch (chunk > 1)")
        if c.num_chips > 1:
            missing.append("multi-device stripes (num_chips > 1)")
        if c.bitstream != "spec":
            missing.append(f"bitstream {c.bitstream!r}")
        if missing:
            raise NotImplementedError(
                "not ported to av1tpu_torch yet: " + ", ".join(missing))
        self._order_hint = 0
        self._gop_deblock = False
        self._qround = float(c.qround)
        self._cdef = bool(c.cdef)
        self._lr = bool(c.lr)
        # per-block LAST/GOLDEN selection: slot 1 holds the GOP keyframe
        self._golden = bool(c.golden)

    @property
    def _ref(self):
        """Reference recon planes materialized to host int32."""
        if self._ref_dev is None:
            return None
        return tuple(p.cpu().numpy().astype(np.int32) for p in self._ref_dev)

    def start_stream(self) -> None:
        super().start_stream()
        self._order_hint = 0
        self._gop_deblock = False

    def _submit(self, frame, qindex, force_key: bool = False,
                is_key: Optional[bool] = None, refresh: bool = True):
        if is_key is None:
            is_key = self._decide_key(frame, force_key)
        if self._ref_dev is None:
            is_key = True
        h, w = frame.height, frame.width
        bd = frame.bit_depth
        if bd not in (8, 10):
            raise NotImplementedError(f"bit depth {bd}")
        yp, up, vp = self._pad_planes(frame, 64)
        ph, pw = yp.shape
        true_ok = _axis_true_dims_ok(w) and _axis_true_dims_ok(h, True)
        th, tw = (h, w) if true_ok else (ph, pw)
        oh = self._order_hint & 127
        self._order_hint += 1
        dev = self.device
        yj, uj, vj = (_upload(p, dev) for p in (yp, up, vp))
        total = ph * pw + 2 * (ph // 2) * (pw // 2)
        cap = total // SPARSE_CAP_FRACTION
        qindex = int(qindex)
        if is_key:
            # deblocking is decided per GOP: on for smooth sources, off
            # for grainy ones (the engine's own rule)
            self._gop_deblock = (noise_floor(frame.y) <= 1.0
                                 and (th % 32 == 0
                                      or (th % 32 == 16
                                          and tw % 16 == 0)))
        lfy, lfuv = lf_levels(qindex, bd) if self._gop_deblock else (0, 0)
        damp = cdef_damping(qindex) if self._cdef else None
        filters = dict(lf_y=lfy, lf_uv=lfuv, deblock=self._gop_deblock,
                       cdef=self._cdef, cdef_damping=damp or 4, lr=self._lr)
        if is_key:
            _, _, brs = _tile_plan(th)
            out = torch_intra.encode_frame(
                yj, uj, vj, qindex, nbr=ph // 32, nbc=pw // 32,
                bit_depth=bd, th=th, tw=tw, tile_row_starts=brs,
                qround=self._qround, **filters)
            # the filtered recon is both LAST and the GOP's GOLDEN
            self._ref_dev = out[0:3]
            self._golden_dev = out[0:3]
            grids = torch.cat([out[i].reshape(-1) for i in range(6, 19)])
            pk = pack_outputs(out[3], out[4], out[5], grids, cap)
            return ("key", qindex, w, h, th, tw, ph, pw, bd, oh, refresh,
                    out, pk, cap, lfy, lfuv, damp, self._lr, self._golden)
        refs = self._ref_dev
        out = torch_inter.encode_frame(
            yj, uj, vj, refs[0], refs[1], refs[2], qindex, bd, th=th, tw=tw,
            qround=self._qround,
            gld=self._golden_dev if self._golden else None, **filters)
        if refresh:
            self._ref_dev = out[5:8]
        grids = torch.cat([out[i].reshape(-1)
                           for i in (0, 1, 8, 9, 10, 11, 12, 13, 14, 15)])
        pk = pack_outputs(out[2], out[3], out[4], grids, cap)
        return ("inter", qindex, w, h, th, tw, ph, pw, bd, oh, refresh,
                out, pk, cap, lfy, lfuv, damp, self._lr, self._golden)

    @staticmethod
    def _finalize(pending) -> tuple[bytes, bool]:
        """Materialize a pending frame and entropy-code it (header and
        tile assembly copied from the JAX engine's _finalize)."""
        (kind, qindex, w, h, th, tw, ph, pw, bd, oh, refresh, out,
         pk, cap, lfy, lfuv, cdamp, lr_on, golden_on) = pending
        rs = (w, h) if (tw, th) != (w, h) else None
        mi_cols, mi_rows = 2 * ((tw + 7) >> 3), 2 * ((th + 7) >> 3)
        gh_t, gw_t = (mi_rows + 7) // 8, (mi_cols + 7) // 8
        gh, gw = ph // 32, pw // 32
        shapes = [(ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2)]
        trl2, spans, _ = _tile_plan(th)
        maskbytes, vals, count, grids = (t.cpu().numpy() for t in pk)
        lvs = _unpack_levels(maskbytes, vals, count, shapes)
        strip = (th % 32) == 16
        nsc = 2 * gw
        B = gh * gw
        urows, ucols = _lr_nru(th, tw)
        nru = urows * ucols
        # layouts -- key:   [mode B][uv B][skip B][angle B][split B]
        #                   [m16 4B][uv16 4B][a16 4B][s16 4B]
        #                   [strip nsc][cdefs 4][lr nru][taps 6nru]
        #            inter: [mv8 2B][skip B][strip nsc][cdefs 4][lr nru]
        #                   [split B][mv16 8B][skip16 4B][refsel B]
        #                   [taps 6nru]
        cdef_off = (21 * B if kind == "key" else 3 * B) + nsc
        lr_arg = None
        lr_kw = {}
        if lr_on:
            lr_choice = grids[cdef_off + 4:cdef_off + 4 + nru].reshape(
                urows, ucols)
            lr_arg = (256,) + _lr_table(lr_choice,
                                        grids[-6 * nru:].reshape(nru, 6))
            lr_kw["lr_types"] = (1, 0, 0)
        cdef_hdr = None
        if cdamp is not None:
            cdef_hdr = (cdamp,) + tuple(
                int(x) for x in grids[cdef_off:cdef_off + 4])
        if kind == "key":
            if lvs is None:
                lvs = [t.cpu().numpy() for t in out[3:6]]
            lv_y, lv_u, lv_v = lvs
            ng = B
            g_mode = grids[:ng].reshape(gh, gw)
            g_uv = grids[ng:2 * ng].reshape(gh, gw)
            g_skip = grids[2 * ng:3 * ng].reshape(gh, gw)
            g_angle = grids[3 * ng:4 * ng].reshape(gh, gw)
            g_split = grids[4 * ng:5 * ng].reshape(gh, gw)
            g_m16 = grids[5 * ng:9 * ng].reshape(gh, gw, 4)
            g_uv16 = grids[9 * ng:13 * ng].reshape(gh, gw, 4)
            g_a16 = grids[13 * ng:17 * ng].reshape(gh, gw, 4)
            g_s16 = grids[17 * ng:21 * ng].reshape(gh, gw, 4)
            strip_skip = grids[21 * ng:21 * ng + nsc] if strip else None
            tiles = native.encode_tile_rows(
                "key", qindex, mi_cols, mi_rows, spans,
                (g_mode[:gh_t, :gw_t], g_uv[:gh_t, :gw_t],
                 g_skip[:gh_t, :gw_t]), lv_y, lv_u, lv_v,
                strip_skip=strip_skip, lr=lr_arg,
                angles=g_angle[:gh_t, :gw_t],
                key_split5=(g_split[:gh_t, :gw_t], g_m16[:gh_t, :gw_t],
                            g_uv16[:gh_t, :gw_t], g_a16[:gh_t, :gw_t],
                            g_s16[:gh_t, :gw_t]))
            hdr = W.write_key_frame_header(tw, th, qindex, order_hint=oh,
                                           render_size=rs,
                                           tile_rows_log2=trl2,
                                           lf_level=lfy, lf_level_uv=lfuv,
                                           cdef=cdef_hdr, **lr_kw)
            hdr.byte_align()
            seq = SpecSequenceHeader(
                w, h, bd, enable_cdef=cdamp is not None,
                enable_restoration=lr_on).seq_obu()
            payload = seq + obu_mod.make_obu(
                obu_mod.OBU_FRAME,
                hdr.tobytes() + W.assemble_tile_group(tiles))
            return payload, True
        if lvs is None:
            lvs = [t.cpu().numpy() for t in out[2:5]]
        ylv, ulv, vlv = lvs
        mv8 = grids[:2 * B].reshape(B, 2)
        skip = grids[2 * B:3 * B]
        strip_skip = grids[3 * B:3 * B + nsc] if strip else None
        tail = cdef_off + 4 + nru
        splits = grids[tail:tail + B].reshape(gh, gw)
        mvs16 = grids[tail + B:tail + 9 * B].reshape(gh, gw, 4, 2)
        skips16 = grids[tail + 9 * B:tail + 13 * B].reshape(gh, gw, 4)
        refsel = grids[tail + 13 * B:tail + 14 * B].reshape(gh, gw)
        # inter mode grid: 1 = inter/LAST, 4 = inter/GOLDEN (slot 1)
        modes = (1 + 3 * refsel[:gh_t, :gw_t]).astype(np.int32)
        tiles = native.encode_tile_rows(
            "inter", qindex, mi_cols, mi_rows, spans,
            (modes, mv8.reshape(gh, gw, 2)[:gh_t, :gw_t],
             skip.reshape(gh, gw)[:gh_t, :gw_t]),
            ylv, ulv, vlv, strip_skip=strip_skip, lr=lr_arg,
            split3=(splits[:gh_t, :gw_t], mvs16[:gh_t, :gw_t],
                    skips16[:gh_t, :gw_t]))
        hdr = W.write_inter_frame_header(
            tw, th, qindex, order_hint=oh,
            refresh_frame_flags=0x01 if refresh else 0x00,
            ref_slots=(0, 0, 0, 1, 0, 0, 0) if golden_on else (0,) * 7,
            render_size=rs, tile_rows_log2=trl2,
            lf_level=lfy, lf_level_uv=lfuv, cdef=cdef_hdr, **lr_kw)
        hdr.byte_align()
        payload = obu_mod.make_obu(
            obu_mod.OBU_FRAME, hdr.tobytes() + W.assemble_tile_group(tiles))
        return payload, False

    # ---- daemon surface -------------------------------------------------
    def sequence_header(self, width: int, height: int, bit_depth: int = 8,
                        source_stream=None) -> SpecSequenceHeader:
        sh = SpecSequenceHeader(width, height, bit_depth)
        if source_stream is not None:
            sh.color_primaries = getattr(source_stream,
                                         "color_primaries_code", 0)
            sh.color_transfer = getattr(source_stream,
                                        "color_transfer_code", 0)
            sh.color_matrix = getattr(source_stream, "color_matrix_code",
                                      0)
        return sh

    def codec_private(self, sh) -> bytes:
        return sh.av1c()
