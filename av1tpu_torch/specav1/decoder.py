# Copied from av1tpu/specav1/decoder.py (without the uniform-grid deblocking
# shortcut, which reaches a JAX module; departure: it keeps RefOrderHint per
# slot for the header parser's RefFrameSignBias).
"""Top-level spec-AV1 decoder: temporal units -> frames.

Decodes what the port encodes: KEY and INTER frames, one or two
references, and the in-loop filters in the spec's order, all numpy:
deblocking (from the decoded per-4x4 grids), CDEF (one strength pair
per frame, ``cdef_bits = 0``) and loop restoration, whose stripe
boundaries read the post-deblock, pre-CDEF planes.
"""

from __future__ import annotations

import numpy as np

from av1tpu_torch.specav1 import cdef as cdef_mod
from av1tpu_torch.specav1 import headers, loopfilter, obu
from av1tpu_torch.specav1 import lr as lr_mod
from av1tpu_torch.specav1.bits import BitReader
from av1tpu_torch.specav1.cdfs import FrameContext
from av1tpu_torch.specav1.tile import (BLOCK_SIZES, TX_SIZES_ALL,
                                       TileDecoder, _chroma_tx_size)


class Decoder:
    def __init__(self):
        self.seq: headers.SequenceHeader | None = None
        self.ref_frames: list = [None] * 8
        self.ref_slot_meta: list = [None] * 8  # (planes, width, height)
        self.ref_order_hint: list = [0] * 8

    def decode_tu(self, tu: bytes) -> list:
        """Decode one temporal unit; returns list of (y, u, v) planes."""
        out = []
        for o in obu.parse_obus(tu):
            if o.type == obu.OBU_SEQUENCE_HEADER:
                self.seq = headers.parse_sequence_header(o.payload)
            elif o.type == obu.OBU_FRAME:
                out.extend(self._decode_frame_obu(o.payload))
            elif o.type == obu.OBU_FRAME_HEADER:
                raise NotImplementedError("separate frame header OBUs")
            elif o.type in (obu.OBU_TEMPORAL_DELIMITER, obu.OBU_PADDING,
                            obu.OBU_METADATA):
                continue
        return out

    def _decode_frame_obu(self, payload: bytes) -> list:
        assert self.seq is not None, "no sequence header seen"
        seq = self.seq
        hdr = headers.parse_frame_header(payload, seq,
                                         ref_order_hint=self.ref_order_hint)
        if hdr.show_existing_frame:
            planes, w, h = self.ref_slot_meta[hdr.frame_to_show_map_idx]
            return [self._crop_dims(planes, w, h)]
        # byte-align then tile group
        pos = (hdr.header_bits + 7) & ~7
        b = BitReader(payload, pos)
        num_tiles = hdr.tile_cols * hdr.tile_rows
        tg_start, tg_end = 0, num_tiles - 1
        if num_tiles > 1:
            if b.f(1):  # tile_start_and_end_present_flag
                bits = hdr.tile_cols_log2 + hdr.tile_rows_log2
                tg_start = b.f(bits)
                tg_end = b.f(bits)
        b.byte_align()
        fc = FrameContext(hdr.base_q_idx)
        td = TileDecoder(seq, hdr, fc,
                         ref_planes=None if hdr.frame_is_intra()
                         else self.ref_frames)
        data = payload[b.pos // 8:]
        off = 0
        for tn in range(tg_start, tg_end + 1):
            tr, tc = tn // hdr.tile_cols, tn % hdr.tile_cols
            if tn == tg_end:
                tile_data = data[off:]
            else:
                sz = int.from_bytes(
                    data[off:off + hdr.tile_size_bytes], "little") + 1
                off += hdr.tile_size_bytes
                tile_data = data[off:off + sz]
                off += sz
            if tn > tg_start:
                # spec 5.11.2 init_symbol: every tile starts from the
                # frame-initial CDF state; carrying tile 1's adapted
                # CDFs into tile 2 desyncs msac (caught by the fast
                # full-HD multi-tile conformance test)
                td.fc = FrameContext(hdr.base_q_idx)
            td.decode_tile(tile_data,
                           hdr.mi_row_starts[tr], hdr.mi_row_starts[tr + 1],
                           hdr.mi_col_starts[tc], hdr.mi_col_starts[tc + 1])
        full = self._finish_frame(td, hdr)
        # reference slots hold the frame cropped to its coded dims: the
        # spec clamps inter reads against FrameWidth/Height, not the
        # decoder's internal SB padding
        cropped = self._crop_dims(full, hdr.frame_width, hdr.frame_height)
        self.ref_order_hint = list(hdr.ref_order_hint)
        for i in range(8):
            if hdr.refresh_frame_flags & (1 << i):
                self.ref_order_hint[i] = hdr.order_hint
                self.ref_frames[i] = cropped
                self.ref_slot_meta[i] = (cropped, hdr.frame_width,
                                         hdr.frame_height)
        if not hdr.show_frame:
            return []
        return [self._crop_dims(full, hdr.frame_width, hdr.frame_height)]

    def _finish_frame(self, td: TileDecoder, hdr) -> tuple:
        """Returns the FULL coded-size planes (reference slots keep the
        SB-padded area: inter prediction clamps against coded dims).
        In-loop filter order per spec: deblock -> CDEF -> LR."""
        planes = (td.planes[0], td.planes[1], td.planes[2])
        if any(hdr.lf.level):
            planes = self._deblock(td, hdr, planes)
        pre_cdef = planes  # post-deblock: LR stripe-boundary source
        c = hdr.cdef
        if any(c.y_pri) or any(c.y_sec) or any(c.uv_pri) or any(c.uv_sec):
            if c.bits:
                # cdef_bits > 0 streams carry per-64x64 cdef_idx bits in
                # the tiles, which TileDecoder does not read — the
                # arithmetic decode would already have desynced
                raise NotImplementedError("cdef_bits > 0")
            fy, fu, fv = cdef_mod.cdef_frame(
                planes, td.skips, y_pri=c.y_pri[0], y_sec=c.y_sec[0],
                uv_pri=c.uv_pri[0], uv_sec=c.uv_sec[0],
                damping=c.damping, bit_depth=self.seq.bit_depth,
                th=hdr.frame_height, tw=hdr.frame_width)
            dt = planes[0].dtype
            planes = (fy.astype(dt), fu.astype(dt), fv.astype(dt))
        if hdr.lr.uses_lr:
            # spec 7.17; td.lr_state carries the per-RU syntax read in
            # the tiles
            fy, fu, fv = lr_mod.apply_lr_frame(
                td.lr_state, planes, pre_cdef, self.seq.bit_depth,
                hdr.frame_height, hdr.frame_width)
            dt = planes[0].dtype
            planes = (fy.astype(dt), fu.astype(dt), fv.astype(dt))
        return planes

    def _deblock(self, td: TileDecoder, hdr, planes) -> tuple:
        """Spec deblocking (7.14) from the decoded grids: every stream
        the encoder emits (uniform 32x32, PARTITION_SPLIT 16s, strip
        rows) and one-level var-tx streams whose blocks are all
        >= 8x8 px."""
        if hdr.lf.delta_enabled or hdr.delta_lf_present:
            raise NotImplementedError(
                "loop filter with per-ref/mode or per-block level deltas")
        # block dims from mi_size (mvgrid only covers inter frames;
        # mi_size is filled on every path)
        bs_tab = np.asarray(BLOCK_SIZES, np.int32)
        n4_w = bs_tab[td.mi_size][..., 0]
        n4_h = bs_tab[td.mi_size][..., 1]
        if n4_w.min() < 2 or n4_h.min() < 2:
            raise NotImplementedError(
                "loop filter with sub-8x8 blocks (chroma owner-edge "
                "geometry not modeled)")
        nbs = int(td.mi_size.max()) + 1
        lut_w = np.ones((nbs,), np.int32)
        lut_h = np.ones((nbs,), np.int32)
        for bs in np.unique(td.mi_size):
            tw_, th_ = TX_SIZES_ALL[_chroma_tx_size(int(bs), 1, 1)]
            lut_w[bs], lut_h[bs] = tw_ >> 2, th_ >> 2
        mr, mc = td.tx_w4.shape
        ri = np.minimum(np.arange((mr + 1) // 2) * 2 + 1, mr - 1)
        ci = np.minimum(np.arange((mc + 1) // 2) * 2 + 1, mc - 1)
        owner = td.mi_size[np.ix_(ri, ci)]
        return loopfilter.deblock_frame_general(
            planes, tuple(hdr.lf.level), hdr.lf.sharpness, td.tx_w4,
            td.tx_h4, n4_w, n4_h, td.skips, td.mvgrid.ref > 0, lut_w[owner],
            lut_h[owner], self.seq.bit_depth)

    def _crop_dims(self, planes, w, h) -> tuple:
        y, u, v = planes
        ssx, ssy = self.seq.subsampling_x, self.seq.subsampling_y
        cw = (w + ssx) >> ssx
        ch = (h + ssy) >> ssy
        return (y[:h, :w].copy(), u[:ch, :cw].copy(), v[:ch, :cw].copy())


def decode_stream(tus) -> list:
    d = Decoder()
    frames = []
    for tu in tus:
        frames.extend(d.decode_tu(bytes(tu)))
    return frames
