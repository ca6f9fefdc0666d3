# Copied from av1tpu/specav1/writer.py (two departures in TileWriter's MV
# stacks, marked where they are: the frame's RefFrameSignBias, and the MV
# grid keeping a block's coded size, as the decoder copy does).
"""Spec-AV1 bitstream writer: sequence and frame headers, tile rows
and the tile group, and the Python tile-symbol writer.

The write-side dual of the decoder's header parser
(``specav1/headers.py``).  The engine's tile symbols are emitted by the
native tile writer (``specav1/native.py``).  ``TileWriter`` mirrors
TileDecoder's context model (partition context bytes, skip ctx, txb ctx
chains, scan orders), emitting through the C++ daala coder of the same
library; only the host reference encoder (``specav1/encode.py``, a test
reference) uses it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from av1tpu_torch.encoder import entropy
from av1tpu_torch.specav1 import headers, mvrefs, recon
from av1tpu_torch.specav1 import tile as T
from av1tpu_torch.specav1 import obu as obu_mod
from av1tpu_torch.specav1.bits import BitWriter
from av1tpu_torch.specav1.cdfs import FrameContext


# the order hints write_sequence_header signals (order_hint_bits_minus_1 6)
_SEQ_HINTS = headers.SequenceHeader(enable_order_hint=1, order_hint_bits=7)


def ref_frame_sign_bias(order_hint: int, slot_hints,
                        ref_slots=(0,) * 7) -> tuple:
    """RefFrameSignBias, indexed by reference frame (LAST_FRAME = 1), that
    a decoder derives for an inter frame written with ``order_hint`` and
    ``ref_slots`` (its ref_frame_idx) from the slots' order hints
    (``slot_hints``, 8): 1 where the slot's frame is a future one to the
    7-bit hints (spec 5.9.2)."""
    return (0,) + tuple(
        int(headers.get_relative_dist(_SEQ_HINTS, slot_hints[slot],
                                      order_hint) > 0)
        for slot in ref_slots)


def write_sequence_header(w: int, h: int, *, bit_depth: int = 8,
                          mono: bool = False,
                          color_primaries: int | None = None,
                          transfer: int | None = None,
                          matrix: int | None = None,
                          color_range: int = 0,
                          enable_cdef: bool = False,
                          enable_restoration: bool = False) -> bytes:
    """Minimal level-capable sequence header (profile 0, 4:2:0)."""
    b = BitWriter()
    b.f(0, 3)      # seq_profile
    b.f(0, 1)      # still_picture
    b.f(0, 1)      # reduced_still_picture_header
    b.f(0, 1)      # timing_info_present
    b.f(0, 1)      # initial_display_delay_present
    b.f(0, 5)      # operating_points_cnt_minus_1
    b.f(0, 12)     # operating_point_idc
    b.f(0, 5)      # seq_level_idx (2.0)
    b.f(15, 4)     # frame_width_bits_minus_1
    b.f(15, 4)     # frame_height_bits_minus_1
    b.f(w - 1, 16)
    b.f(h - 1, 16)
    b.f(0, 1)      # frame_id_numbers_present
    b.f(0, 1)      # use_128x128_superblock
    b.f(0, 1)      # enable_filter_intra
    b.f(0, 1)      # enable_intra_edge_filter
    b.f(0, 1)      # enable_interintra_compound
    b.f(0, 1)      # enable_masked_compound
    b.f(0, 1)      # enable_warped_motion
    b.f(0, 1)      # enable_dual_filter
    b.f(1, 1)      # enable_order_hint
    b.f(0, 1)      # enable_jnt_comp
    b.f(0, 1)      # enable_ref_frame_mvs
    b.f(0, 1)      # seq_choose_screen_content_tools
    b.f(0, 1)      # seq_force_screen_content_tools = 0
    b.f(6, 3)      # order_hint_bits_minus_1 -> 7 bits
    b.f(0, 1)      # enable_superres
    b.f(1 if enable_cdef else 0, 1)
    b.f(1 if enable_restoration else 0, 1)
    # color_config
    b.f(1 if bit_depth > 8 else 0, 1)
    b.f(1 if mono else 0, 1)
    describe = color_primaries is not None
    b.f(1 if describe else 0, 1)
    if describe:
        b.f(color_primaries, 8)
        b.f(transfer if transfer is not None else 2, 8)
        b.f(matrix if matrix is not None else 2, 8)
    if mono:
        b.f(color_range, 1)
    else:
        b.f(color_range, 1)
        b.f(0, 2)  # chroma_sample_position
        b.f(0, 1)  # separate_uv_delta_q
    b.f(0, 1)      # film_grain_params_present
    b.trailing_bits()
    return obu_mod.make_obu(obu_mod.OBU_SEQUENCE_HEADER, b.tobytes())


def _write_cdef_lr(b: BitWriter, cdef: tuple | None,
                   lr_types: tuple | None, lr_unit_size: int = 256,
                   lr_uv_shift: int = 0) -> None:
    """cdef_params + lr_params (spec 5.9.19/5.9.20).  The caller's
    sequence header must set enable_cdef/enable_restoration to match
    (None here = the seq gate is off, no bits).

    cdef: (damping, y_pri, y_sec, uv_pri, uv_sec) with cdef_bits = 0
    (one strength pair; no per-64x64 cdef_idx bits in tiles).
    lr_types: per-plane frame_restoration_type (RESTORE_NONE only for
    now — nonzero types would add per-RU tile syntax)."""
    if cdef is not None:
        damping, y_pri, y_sec, uv_pri, uv_sec = cdef
        b.f(damping - 3, 2)
        b.f(0, 2)          # cdef_bits = 0
        for pri, sec in ((y_pri, y_sec), (uv_pri, uv_sec)):
            assert 0 <= pri <= 15 and sec in (0, 1, 2, 4), (pri, sec)
            b.f(pri, 4)
            b.f(3 if sec == 4 else sec, 2)
    if lr_types is not None:
        # lr_params (5.9.20): frame_restoration_type per plane coded
        # through the inverse of Remap_Lr_Type (NONE->0, SWITCHABLE->1,
        # WIENER->2, SGRPROJ->3), then unit-size shifts
        inv_remap = {0: 0, 3: 1, 1: 2, 2: 3}
        uses_lr = any(lr_types)
        uses_chroma_lr = any(lr_types[1:])
        for t in lr_types:
            b.f(inv_remap[t], 2)
        if uses_lr:
            size = lr_unit_size or 256
            shift = {64: 0, 128: 1, 256: 2}[size]
            b.f(1 if shift else 0, 1)
            if shift:
                b.f(shift - 1, 1)
            if uses_chroma_lr:
                b.f(lr_uv_shift, 1)


def write_key_frame_header(w: int, h: int, qidx: int, *,
                           order_hint: int = 0,
                           disable_cdf_update: int = 0,
                           reduced_tx_set: int = 0,
                           tx_mode_select: int = 0,
                           tile_rows_log2: int = 0,
                           lf_level: int = 0, lf_level_uv: int = 0,
                           cdef: tuple | None = None,
                           lr_types: tuple | None = None,
                           lr_unit_size: int = 256,
                           render_size: tuple | None = None) -> BitWriter:
    """Uncompressed header for a shown KEY frame matching
    write_sequence_header's feature gates (no superres/cdef/lr,
    loop filter off for now).  render_size signals the display
    dimensions when the coded frame is padded to SB multiples."""
    b = BitWriter()
    b.f(0, 1)          # show_existing_frame
    b.f(0, 2)          # frame_type = KEY
    b.f(1, 1)          # show_frame
    b.f(disable_cdf_update, 1)
    b.f(0, 1)          # frame_size_override
    b.f(order_hint, 7)
    if render_size is not None and render_size != (w, h):
        b.f(1, 1)      # render_and_frame_size_different
        b.f(render_size[0] - 1, 16)
        b.f(render_size[1] - 1, 16)
    else:
        b.f(0, 1)
    if not disable_cdf_update:
        b.f(1, 1)      # disable_frame_end_update_cdf
    _write_tile_info(b, w, h, tile_rows_log2)
    b.f(qidx, 8)
    b.f(0, 1)          # delta_q_y_dc
    b.f(0, 1)          # delta_q_u_dc
    b.f(0, 1)          # delta_q_u_ac
    b.f(0, 1)          # using_qmatrix
    b.f(0, 1)          # segmentation_enabled
    b.f(0, 1)          # delta_q_present
    b.f(lf_level, 6)   # loop_filter_level[0]
    b.f(lf_level, 6)   # loop_filter_level[1]
    if lf_level:
        b.f(lf_level_uv, 6)
        b.f(lf_level_uv, 6)
    b.f(0, 3)          # sharpness
    b.f(0, 1)          # delta_enabled
    _write_cdef_lr(b, cdef, lr_types, lr_unit_size)
    b.f(tx_mode_select, 1)
    b.f(reduced_tx_set, 1)
    return b


def _tl2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _write_tile_info(b: BitWriter, w: int, h: int,
                     tile_rows_log2: int = 0) -> None:
    """Uniform tile spacing: single tile column, 2**tile_rows_log2 tile
    rows (spec 5.9.15 tile_info; mirrors headers.parse)."""
    b.f(1, 1)          # uniform_tile_spacing
    mi_cols = 2 * ((w + 7) >> 3)
    mi_rows = 2 * ((h + 7) >> 3)
    sbc = (mi_cols + 15) >> 4
    sbr = (mi_rows + 15) >> 4
    min_log2_cols = _tl2(64, sbc)
    max_log2_cols = _tl2(1, min(sbc, 64))
    min_log2_tiles = max(min_log2_cols, _tl2(4096, sbr * sbc))
    if max_log2_cols > min_log2_cols:
        b.f(0, 1)      # stop at minimum tile_cols_log2
    tile_cols_log2 = min_log2_cols
    assert tile_cols_log2 == 0, "tile columns not emitted yet"
    min_log2_rows = max(min_log2_tiles - tile_cols_log2, 0)
    max_log2_rows = _tl2(1, min(sbr, 64))
    k = max(tile_rows_log2, min_log2_rows)
    for _ in range(min_log2_rows, min(k, max_log2_rows)):
        b.f(1, 1)      # increment_tile_rows_log2
    if k < max_log2_rows:
        b.f(0, 1)
    if tile_cols_log2 > 0 or min(k, max_log2_rows) > 0:
        b.f(0, tile_cols_log2 + min(k, max_log2_rows))  # context_update_tile_id
        b.f(3, 2)      # tile_size_bytes_minus_1 = 3 (4-byte sizes)


def tile_row_spans(h: int, tile_rows_log2: int) -> list:
    """[(mi_row0, mi_row1)] per tile row, uniform spacing (mirrors
    headers.parse: ceil(sbr / 2**log2) superblocks per tile)."""
    mi_rows = 2 * ((h + 7) >> 3)
    sbr = (mi_rows + 15) >> 4
    max_log2_rows = _tl2(1, min(sbr, 64))
    k = min(tile_rows_log2, max_log2_rows)
    ths = (sbr + (1 << k) - 1) >> k
    spans = []
    i = 0
    while i * ths < sbr:
        spans.append((i * ths * 16, min((i + 1) * ths * 16, mi_rows)))
        i += 1
    return spans


def assemble_tile_group(tiles: list) -> bytes:
    """Tile payload for an OBU_FRAME: size fields (4-byte le, minus 1)
    for every tile but the last.  Single tile: raw bytes."""
    if len(tiles) == 1:
        return bytes(tiles[0])
    # tile_start_and_end_present_flag = 0 (required inside OBU_FRAME)
    # + byte alignment
    out = bytearray(b"\x00")
    for t in tiles[:-1]:
        out += (len(t) - 1).to_bytes(4, "little")
        out += t
    out += tiles[-1]
    return bytes(out)


def write_inter_frame_header(w: int, h: int, qidx: int, *,
                             order_hint: int,
                             refresh_frame_flags: int = 0x01,
                             ref_slots: tuple = (0,) * 7,
                             render_size: tuple | None = None,
                             tx_mode_select: int = 0,
                             reduced_tx_set: int = 0,
                             tile_rows_log2: int = 0,
                             lf_level: int = 0,
                             lf_level_uv: int = 0,
                             cdef: tuple | None = None,
                             lr_types: tuple | None = None,
                             lr_unit_size: int = 256,
                             switchable_filter: bool = False,
                             allow_hp: bool = False) -> BitWriter:
    """Uncompressed header for a shown INTER frame matching
    write_sequence_header's gates: primary_ref_frame NONE (default CDFs
    per frame), single-reference (reference_select 0), regular filter,
    loop filter off, no superres/cdef/lr, no temporal MVPs."""
    b = BitWriter()
    b.f(0, 1)              # show_existing_frame
    b.f(1, 2)              # frame_type = INTER
    b.f(1, 1)              # show_frame (showable inferred)
    b.f(0, 1)              # error_resilient_mode
    b.f(0, 1)              # disable_cdf_update (in-frame adaptation ON)
    b.f(0, 1)              # frame_size_override
    b.f(order_hint, 7)
    b.f(7, 3)              # primary_ref_frame = PRIMARY_REF_NONE
    b.f(refresh_frame_flags, 8)
    b.f(0, 1)              # frame_refs_short_signaling
    for slot in ref_slots:
        b.f(slot, 3)       # ref_frame_idx[i]
    # frame_size(): override 0 -> coded dims = seq max, no bits
    if render_size is not None and render_size != (w, h):
        b.f(1, 1)
        b.f(render_size[0] - 1, 16)
        b.f(render_size[1] - 1, 16)
    else:
        b.f(0, 1)
    b.f(1 if allow_hp else 0, 1)   # allow_high_precision_mv
    if switchable_filter:
        b.f(1, 1)          # is_filter_switchable
    else:
        b.f(0, 1)          # is_filter_switchable
        b.f(0, 2)          # interpolation_filter = EIGHTTAP_REGULAR
    b.f(0, 1)              # is_motion_mode_switchable
    b.f(1, 1)              # disable_frame_end_update_cdf
    _write_tile_info(b, w, h, tile_rows_log2)
    b.f(qidx, 8)
    b.f(0, 1)              # delta_q_y_dc
    b.f(0, 1)              # delta_q_u_dc (diff_uv_delta absent: sep=0)
    b.f(0, 1)              # delta_q_u_ac
    b.f(0, 1)              # using_qmatrix
    b.f(0, 1)              # segmentation_enabled
    b.f(0, 1)              # delta_q_present
    b.f(lf_level, 6)       # loop_filter_level[0]
    b.f(lf_level, 6)       # loop_filter_level[1]
    if lf_level:
        b.f(lf_level_uv, 6)
        b.f(lf_level_uv, 6)
    b.f(0, 3)              # sharpness
    b.f(0, 1)              # mode_ref_delta_enabled
    _write_cdef_lr(b, cdef, lr_types, lr_unit_size)
    b.f(tx_mode_select, 1)
    b.f(0, 1)              # reference_select (single reference)
    # skip_mode_params: not allowed (reference_select 0) -> no bit
    # allow_warped_motion: seq disables -> no bit
    b.f(reduced_tx_set, 1)
    for _ in range(7):
        b.f(0, 1)          # is_global[ref] = 0 (IDENTITY)
    return b


def assemble_interframe(w: int, h: int, qidx: int, tile_data: bytes,
                        **hdr_kw) -> bytes:
    """TD + frame OBU for a single-tile inter frame (sequence header
    carried by the stream's keyframe TU)."""
    hdr = write_inter_frame_header(w, h, qidx, **hdr_kw)
    hdr.byte_align()
    return obu_mod.temporal_delimiter() + \
        obu_mod.make_obu(obu_mod.OBU_FRAME, hdr.tobytes() + tile_data)


class TileWriter:
    """Symbol emitter mirroring TileDecoder's context model."""

    def __init__(self, fc: FrameContext, mi_cols: int, mi_rows: int,
                 base_q_idx: int, reduced_tx_set: int = 0,
                 sign_bias=None):
        self.lib = entropy.load_library()
        # the frame's RefFrameSignBias by reference frame (None: all 0)
        self.sign_bias = sign_bias
        self.fc = fc
        self.mi_cols, self.mi_rows = mi_cols, mi_rows
        self.base_q_idx = base_q_idx
        self.reduced_tx_set = reduced_tx_set
        self.sb4 = 16
        self.enc = self.lib.ec_enc_create()
        self.lib.ec_enc_reset(self.enc)
        n = mi_cols
        self.above_part = np.zeros(n, np.int32)
        self.above_levels = [np.zeros(n, np.int32) for _ in range(3)]
        self.above_dcsign = [np.zeros(n, np.int32) for _ in range(3)]
        self.left_part = np.zeros(self.sb4, np.int32)
        self.left_levels = [np.zeros(self.sb4, np.int32) for _ in range(3)]
        self.left_dcsign = [np.zeros(self.sb4, np.int32) for _ in range(3)]
        self.skips = np.zeros((mi_rows, mi_cols), np.int32)
        self.y_modes = np.zeros((mi_rows, mi_cols), np.int32)
        self.mi_size = np.zeros((mi_rows, mi_cols), np.int32)
        self.filters = np.full((mi_rows, mi_cols), 3, np.int8)
        # tx-size contexts (txfm_partition / tx depth reads)
        self.above_txw = np.full(mi_cols, 64, np.int32)
        self.left_txh = np.full(self.sb4, 64, np.int32)
        self.sb_row = 0
        # inter-frame state (mirrors TileDecoder's)
        self.mvgrid = mvrefs.MvGrid.create(mi_rows, mi_cols)
        self.tile = (0, mi_rows, 0, mi_cols)

    def start_sb_row(self, mi_row: int) -> None:
        self.sb_row = mi_row
        self.left_part[:] = 0
        self.left_txh[:] = 64
        for p in range(3):
            self.left_levels[p][:] = 0
            self.left_dcsign[p][:] = 0

    def sym(self, s: int, cdf: np.ndarray, nsyms: int | None = None):
        if nsyms is None:
            nsyms = len(cdf) - 1
        arr = np.ascontiguousarray(np.asarray(cdf, np.uint16))
        self.lib.ec_enc_symbol_adapt(
            self.enc, int(s), arr.ctypes.data_as(ctypes.c_void_p), nsyms)
        cdf[:len(arr)] = arr

    def literal(self, v: int, n: int) -> None:
        self.lib.ec_enc_literal(self.enc, int(v), n)

    # --- partition ----------------------------------------------------
    def partition(self, r: int, c: int, bsize: int, part: int) -> None:
        w4, _ = T.BLOCK_SIZES[bsize]
        bsl = w4.bit_length() - 1
        half = w4 >> 1
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        above = int((self.above_part[c] >> bsl) & 1) if r > 0 else 0
        left = int((self.left_part[(r - self.sb_row) & 15] >> bsl) & 1) \
            if c > 0 else 0
        ctx = left * 2 + above
        nsyms = {1: 4, 2: 10, 3: 10, 4: 10, 5: 8}[bsl]
        if not (has_rows and has_cols):
            if not (has_rows or has_cols):
                assert part == T.PARTITION_SPLIT
                return  # forced SPLIT: no bits
            # bottom/right edge: a derived bool chooses SPLIT vs
            # HORZ/VERT, with P(split) gathered from the partition CDF
            cdf = self.fc.partition[bsl - 1][ctx]
            f = T.split_bool_f(cdf, bsl, vertical=has_rows)
            bit = 1 if part == T.PARTITION_SPLIT else 0
            self.lib.ec_enc_bool(self.enc, bit, f)
            return
        self.sym(part, self.fc.partition[bsl - 1][ctx], nsyms)

    def update_partition_ctx_rect(self, r: int, c: int, bsize: int,
                                  part: int) -> None:
        """Rect-partition node ctx: decoder writes _partition_context
        of the SUBSIZE over the whole node."""
        w4, h4 = T.BLOCK_SIZES[bsize]
        sub = T._partition_subsize(part, bsize)
        ac, lc = T._partition_context(sub)
        self.above_part[c:c + w4] = ac
        lr = (r - self.sb_row) & (self.sb4 - 1)
        self.left_part[lr:lr + h4] = lc

    def update_partition_ctx_ab(self, r: int, c: int, bsize: int,
                                part: int) -> None:
        """AB-partition node ctx (libaom update_ext_partition_context):
        the rect half records the rect subsize, the split half the
        split subsize, each over its own half's extent."""
        w4, h4 = T.BLOCK_SIZES[bsize]
        sub = T._partition_subsize(part, bsize)
        ssub = T._partition_subsize(T.PARTITION_SPLIT, bsize)

        def upd(rr, cc, size, rw4, rh4):
            ac, lc = T._partition_context(size)
            self.above_part[cc:cc + rw4] = ac
            llr = (rr - self.sb_row) & (self.sb4 - 1)
            self.left_part[llr:llr + rh4] = lc

        if part == T.PARTITION_HORZ_A:
            upd(r, c, ssub, w4, h4 >> 1)
            upd(r + (h4 >> 1), c, sub, w4, h4 >> 1)
        elif part == T.PARTITION_HORZ_B:
            upd(r, c, sub, w4, h4 >> 1)
            upd(r + (h4 >> 1), c, ssub, w4, h4 >> 1)
        elif part == T.PARTITION_VERT_A:
            upd(r, c, ssub, w4 >> 1, h4)
            upd(r, c + (w4 >> 1), sub, w4 >> 1, h4)
        else:  # VERT_B
            upd(r, c, sub, w4 >> 1, h4)
            upd(r, c + (w4 >> 1), ssub, w4 >> 1, h4)

    def update_partition_ctx(self, r: int, c: int, bsize: int) -> None:
        w4, h4 = T.BLOCK_SIZES[bsize]
        ac, lc = T._partition_context(bsize)
        self.above_part[c:c + w4] = ac
        lr = (r - self.sb_row) & 15
        self.left_part[lr:lr + h4] = lc

    # --- block header symbols -------------------------------------------
    def block_intra(self, r: int, c: int, bsize: int, skip: int,
                    y_mode: int, uv_mode: int, angle_y: int = 0,
                    angle_uv: int = 0, has_chroma: bool = True) -> None:
        avail_u = r > 0
        avail_l = c > 0
        ctx = (int(self.skips[r - 1, c]) if avail_u else 0) + \
              (int(self.skips[r, c - 1]) if avail_l else 0)
        self.sym(skip, self.fc.skip[ctx], 2)
        am = int(self.y_modes[r - 1, c]) if avail_u else 0
        lm = int(self.y_modes[r, c - 1]) if avail_l else 0
        self.sym(y_mode, self.fc.kf_y_mode[
            T.INTRA_MODE_CONTEXT[am]][T.INTRA_MODE_CONTEXT[lm]], 13)
        if bsize >= T.BLOCK_8X8 and T.V_PRED <= y_mode <= T.D67_PRED:
            self.sym(angle_y + 3, self.fc.angle_delta[y_mode - T.V_PRED], 7)
        if has_chroma:
            cfl_allowed = int(max(T.BLOCK_SIZES[bsize]) * 4 <= 32)
            self.sym(uv_mode, self.fc.uv_mode[cfl_allowed][y_mode],
                     14 if cfl_allowed else 13)
            if bsize >= T.BLOCK_8X8 and T.V_PRED <= uv_mode <= T.D67_PRED:
                self.sym(angle_uv + 3,
                         self.fc.angle_delta[uv_mode - T.V_PRED], 7)
        w4, h4 = T.BLOCK_SIZES[bsize]
        bw4 = min(w4, self.mi_cols - c)
        bh4 = min(h4, self.mi_rows - r)
        self.skips[r:r + bh4, c:c + bw4] = skip
        self.y_modes[r:r + bh4, c:c + bw4] = y_mode
        self.mi_size[r:r + bh4, c:c + bw4] = bsize
        if skip:
            # reset entropy contexts over the block area for all planes
            self._reset_block_ctx(r, c, bw4, bh4)

    def _reset_block_ctx(self, r, c, bw4, bh4):
        for p in range(3):
            ss = 1 if p else 0
            c4 = c >> ss << ss if False else c
            self.above_levels[p][c:c + bw4] = 0
            self.above_dcsign[p][c:c + bw4] = 0
            lr = (r - self.sb_row) & 15
            self.left_levels[p][lr:lr + bh4] = 0
            self.left_dcsign[p][lr:lr + bh4] = 0

    # --- inter-frame blocks (write-side dual of
    #     TileDecoder._decode_block_interframe) --------------------------
    def mv_stack(self, r: int, c: int, bsize: int, ref_frame: int):
        w4, h4 = T.BLOCK_SIZES[bsize]
        return mvrefs.find_mv_stack(self.mvgrid, r, c, w4, h4, ref_frame,
                                    self.tile, self.sign_bias)

    def _skip_and_inter(self, r, c, skip, is_inter):
        ctx = (int(self.skips[r - 1, c]) if r > 0 else 0) + \
              (int(self.skips[r, c - 1]) if c > 0 else 0)
        self.sym(skip, self.fc.skip[ctx], 2)
        ii = mvrefs.intra_inter_ctx(self.mvgrid, r, c, self.tile)
        self.sym(is_inter, self.fc.intra_inter[ii], 2)

    def block_inter(self, r: int, c: int, bsize: int, skip: int,
                    ref_frame: int, y_mode: int, mv: tuple,
                    stack, interp: int | None = None,
                    var_tx_split=None, ref_mv_idx: int = 0,
                    allow_hp: bool = False) -> None:
        """Emit one single-ref inter block (mode in NEARESTMV..NEWMV);
        `stack` from self.mv_stack (computed BEFORE this call).
        interp: the per-block filter when the frame header signals
        SWITCHABLE (None = frame-uniform filter, no symbol)."""
        fc = self.fc
        self._skip_and_inter(r, c, skip, 1)
        # read_ref_frames dual (full single-ref tree, spec 5.11.25)
        p1, p3, p4, p5, p2, p6 = mvrefs.single_ref_ctxs(
            self.mvgrid, r, c, self.tile)
        assert mvrefs.LAST_FRAME <= ref_frame <= mvrefs.ALTREF_FRAME
        is_bwd = int(ref_frame >= mvrefs.BWDREF_FRAME)
        self.sym(is_bwd, fc.single_ref[p1][0], 2)
        if is_bwd:
            is_alt = int(ref_frame == mvrefs.ALTREF_FRAME)
            self.sym(is_alt, fc.single_ref[p2][1], 2)
            if not is_alt:
                self.sym(int(ref_frame == mvrefs.ALTREF2_FRAME),
                         fc.single_ref[p6][5], 2)
        else:
            in_l3g = int(ref_frame in (mvrefs.LAST3_FRAME,
                                       mvrefs.GOLDEN_FRAME))
            self.sym(in_l3g, fc.single_ref[p3][2], 2)
            if in_l3g:
                self.sym(int(ref_frame == mvrefs.GOLDEN_FRAME),
                         fc.single_ref[p5][4], 2)
            else:
                self.sym(int(ref_frame == mvrefs.LAST2_FRAME),
                         fc.single_ref[p4][3], 2)
        # inter mode tree
        self.sym(int(y_mode != T.NEWMV), fc.newmv[stack.new_mv_ctx], 2)
        if y_mode != T.NEWMV:
            self.sym(int(y_mode != T.GLOBALMV),
                     fc.zeromv[stack.zero_mv_ctx], 2)
            if y_mode != T.GLOBALMV:
                self.sym(int(y_mode != T.NEARESTMV),
                         fc.refmv[stack.ref_mv_ctx], 2)
        # drl: ref_mv_idx selection (spec read_drl_idx)
        if y_mode == T.NEWMV:
            for idx in range(2):
                if stack.num_mv_found > idx + 1:
                    self.sym(int(ref_mv_idx != idx),
                             fc.drl[stack.drl_ctx(idx)], 2)
                    if ref_mv_idx == idx:
                        break
        elif y_mode == T.NEARMV:
            for idx in range(1, 3):
                if stack.num_mv_found > idx + 1:
                    self.sym(int(ref_mv_idx != idx),
                             fc.drl[stack.drl_ctx(idx)], 2)
                    if ref_mv_idx == idx:
                        break
        if y_mode == T.NEWMV:
            pred = stack.ref_mv(ref_mv_idx)
            self._write_mv(mv[0] - pred[0], mv[1] - pred[1], allow_hp)
        if interp is not None:
            # read_interpolation_filter dual (5.11.27; dual_filter off).
            # needs_interp_filter: large GLOBALMV blocks with identity
            # global motion code NO symbol (filter forced EIGHTTAP)
            w4_, h4_ = T.BLOCK_SIZES[bsize]
            large = min(w4_, h4_) * 4 >= 8
            if large and y_mode == T.GLOBALMV:
                assert interp == 0, "GLOBALMV filter is forced EIGHTTAP"
            else:
                ictx = self._interp_filter_ctx(r, c, ref_frame, 0)
                self.sym(interp, fc.switchable_interp[ictx], 3)
        if var_tx_split is not None and not skip:
            # tx_mode SELECT inter blocks code the var-tx split tree
            tx = T.MAX_TX_SIZE_RECT[bsize]
            tw_, th_ = T.TX_SIZES_ALL[tx]
            w4, h4 = T.BLOCK_SIZES[bsize]
            self._var_tx_block = True
            for i in range(0, h4, th_ >> 2):
                for j in range(0, w4, tw_ >> 2):
                    self.write_var_tx_size(r + i, c + j, tx, 0, bsize,
                                           var_tx_split)
        self._finish_block_common(r, c, bsize, skip, T.DC_PRED, ref_frame,
                                  mv, y_mode == T.NEWMV,
                                  interp if interp is not None else 3)
        self._var_tx_block = False

    def block_intra_interframe(self, r: int, c: int, bsize: int,
                               skip: int, y_mode: int,
                               uv_mode: int, tx_depth: int | None = None,
                               angle_y: int = 0, angle_uv: int = 0
                               ) -> int:
        """Returns the block's tx (depth coded when tx_depth given —
        TX_MODE_SELECT non-skip intra blocks)."""
        fc = self.fc
        self._skip_and_inter(r, c, skip, 0)
        self.sym(y_mode, fc.if_y_mode[T.SIZE_GROUP[bsize]], 13)
        if bsize >= T.BLOCK_8X8 and T.V_PRED <= y_mode <= T.D67_PRED:
            self.sym(angle_y + 3, fc.angle_delta[y_mode - T.V_PRED], 7)
        w4, h4 = T.BLOCK_SIZES[bsize]
        has_chroma = not ((w4 == 1 and (c & 1) == 0) or
                          (h4 == 1 and (r & 1) == 0))  # 4:2:0
        if has_chroma:
            cfl_allowed = int(max(T.BLOCK_SIZES[bsize]) * 4 <= 32)
            self.sym(uv_mode, fc.uv_mode[cfl_allowed][y_mode],
                     14 if cfl_allowed else 13)
            if bsize >= T.BLOCK_8X8 and T.V_PRED <= uv_mode <= T.D67_PRED:
                self.sym(angle_uv + 3,
                         fc.angle_delta[uv_mode - T.V_PRED], 7)
        tx = T.MAX_TX_SIZE_RECT[bsize]
        # allowSelect = !skip || !is_inter: intra blocks code the tx
        # depth even when skip (spec 5.11.15)
        if tx_depth is not None:
            t_r0, _, t_c0, _ = self.tile
            tx = self.write_tx_size(r, c, bsize, tx_depth,
                                    r > t_r0, c > t_c0)
        self._finish_block_common(r, c, bsize, skip, y_mode, 0, (0, 0),
                                  False)
        if tx_depth is not None:
            # ctx records the coded tx dims, not the block dims
            tw_, th_ = T.TX_SIZES_ALL[tx]
            w4, h4 = T.BLOCK_SIZES[bsize]
            bw4 = min(w4, self.mi_cols - c)
            bh4 = min(h4, self.mi_rows - r)
            self.above_txw[c:c + bw4] = tw_
            lr = (r - self.sb_row) & (self.sb4 - 1)
            self.left_txh[lr:lr + bh4] = th_
        return tx

    def _finish_block_common(self, r, c, bsize, skip, store_y_mode,
                             ref_frame, mv, is_newmv, interp=3):
        w4, h4 = T.BLOCK_SIZES[bsize]
        bw4 = min(w4, self.mi_cols - c)
        bh4 = min(h4, self.mi_rows - r)
        self.skips[r:r + bh4, c:c + bw4] = skip
        self.y_modes[r:r + bh4, c:c + bw4] = store_y_mode
        self.mi_size[r:r + bh4, c:c + bw4] = bsize
        self.filters[r:r + bh4, c:c + bw4] = interp
        # the block's coded size, as the decoder copy keeps it (departure:
        # the original keeps the visible part, which a block that
        # overhangs the frame's edge gives other MV stack weights)
        self.mvgrid.set_block(r, c, h4, w4, ref_frame, mv, is_newmv)
        if not getattr(self, "_var_tx_block", False):
            # uniform square tx == block dims for this writer's sizes
            # (spec compute_tx_size ctx update; skip-inter records
            # block dims, identical here)
            self.above_txw[c:c + bw4] = min(w4 * 4, 64)
            lr = (r - self.sb_row) & (self.sb4 - 1)
            self.left_txh[lr:lr + bh4] = min(h4 * 4, 64)
        if skip:
            self._reset_block_ctx(r, c, bw4, bh4)

    def write_tx_size(self, r, c, bsize, depth: int,
                      avail_u: bool, avail_l: bool) -> int:
        """read_tx_size dual (intra blocks under TX_MODE_SELECT):
        codes `depth` splits from the max rect tx; returns the tx."""
        max_rect = T.MAX_TX_SIZE_RECT[bsize]
        max_tx_w, max_tx_h = T.TX_SIZES_ALL[max_rect]
        depth_max = T._max_tx_depth(bsize)
        if depth_max == 0:
            return max_rect
        lr = (r - self.sb_row) & (self.sb4 - 1)
        ctx = 0
        if avail_u:
            above = int(self.above_txw[c])
            if int(self.mvgrid.ref[r - 1, c]) > 0:
                above = int(self.mvgrid.n4_w[r - 1, c]) * 4
            ctx += int(above >= max_tx_w)
        if avail_l:
            left = int(self.left_txh[lr])
            if int(self.mvgrid.ref[r, c - 1]) > 0:
                left = int(self.mvgrid.n4_h[r, c - 1]) * 4
            ctx += int(left >= max_tx_h)
        cat = T._tx_size_cat(bsize)
        nsyms = min(depth_max, 2) + 1
        assert 0 <= depth < nsyms
        self.sym(depth, self.fc.tx_size[cat][ctx], nsyms)
        tx = max_rect
        for _ in range(depth):
            tx = T.SPLIT_TX_SIZE[tx]
        return tx

    def write_var_tx_size(self, r, c, tx, depth, bsize,
                          want_split) -> None:
        """read_var_tx_size dual (spec 5.11.46).  want_split(r, c, tx,
        depth) -> bool decides each node; leaves update the tx ctx."""
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        tw, th = T.TX_SIZES_ALL[tx]
        if tx == T.TX_4X4 or depth == 2:
            split = 0
        else:
            ctx = self._txfm_partition_ctx(r, c, bsize, tx)
            split = int(bool(want_split(r, c, tx, depth)))
            self.sym(split, self.fc.txfm_partition[ctx], 2)
        lr = (r - self.sb_row) & (self.sb4 - 1)
        if split:
            sub = T.SPLIT_TX_SIZE[tx]
            sw, sh = T.TX_SIZES_ALL[sub]
            for i in range(0, th >> 2, sh >> 2):
                for j in range(0, tw >> 2, sw >> 2):
                    self.write_var_tx_size(r + i, c + j, sub, depth + 1,
                                           bsize, want_split)
        else:
            h4, w4 = th >> 2, tw >> 2
            self.above_txw[c:c + w4] = tw
            self.left_txh[lr:lr + h4] = th

    def _txfm_partition_ctx(self, r, c, bsize, tx):
        tw, th = T.TX_SIZES_ALL[tx]
        above = int(int(self.above_txw[c]) < tw)
        left_r = (r - self.sb_row) & (self.sb4 - 1)
        left = int(int(self.left_txh[left_r]) < th)
        w4, h4 = T.BLOCK_SIZES[bsize]
        maxdim = min(max(w4, h4) * 4, 64)
        max_tx = {8: 1, 16: 2, 32: 3, 64: 4}[max(maxdim, 8)]
        tx_sqr_up = T.tx_size_sqr_up(tx)
        category = int(tx_sqr_up != max_tx and max_tx > 1) + \
            (4 - max_tx) * 2
        return category * 3 + above + left

    def _interp_filter_ctx(self, r, c, ref_frame, dir_):
        """TileDecoder._interp_filter_ctx dual on writer state."""
        t_r0, _, t_c0, _ = self.tile
        NONE = 3

        def ref_filter(nr, nc):
            if int(self.mvgrid.ref[nr, nc]) <= 0:
                return NONE
            if int(self.mvgrid.ref[nr, nc]) != ref_frame:
                return NONE
            f = int(self.filters[nr, nc])
            return f if f < 3 else NONE

        left = ref_filter(r, c - 1) if c > t_c0 else NONE
        above = ref_filter(r - 1, c) if r > t_r0 else NONE
        ctx = (dir_ & 1) * 4
        if left == above:
            ctx += left
        elif left == NONE:
            ctx += above
        elif above == NONE:
            ctx += left
        else:
            ctx += NONE
        return ctx

    def _write_mv(self, dr: int, dc: int, allow_hp: bool = False) -> None:
        """Write the NEWMV residual (allow_hp 0: all frame MVs are even
        in 1/8 units; allow_hp 1 codes the eighth-pel bit)."""
        joint = (2 if dr else 0) | (1 if dc else 0)
        assert joint != 0, "NEWMV with zero residual: use NEARESTMV"
        self.sym(joint, self.fc.mv_joint, 4)
        if dr:
            self._write_mv_component(0, dr, allow_hp)
        if dc:
            self._write_mv_component(1, dc, allow_hp)

    def _write_mv_component(self, comp: int, d: int,
                            allow_hp: bool = False) -> None:
        m = self.fc.mv[comp]
        sign = int(d < 0)
        mag = -d if sign else d
        z = mag - 1
        if not allow_hp:
            assert z & 1, "odd 1/8-pel MV with allow_high_precision_mv 0"
        self.sym(sign, m.sign, 2)
        if z < 16:
            self.sym(0, m.classes, 11)
            bit = z >> 3
            self.sym(bit, m.class0, 2)
            self.sym((z >> 1) & 3, m.class0_fp[bit], 4)
            if allow_hp:
                self.sym(z & 1, m.class0_hp, 2)
            # else hp inferred 1
        else:
            cls = z.bit_length() - 4
            self.sym(cls, m.classes, 11)
            offset = z - (2 << (cls + 2))
            dbits = offset >> 3
            for i in range(cls):
                self.sym((dbits >> i) & 1, m.bits[i], 2)
            self.sym((offset >> 1) & 3, m.fp, 4)
            if allow_hp:
                self.sym(z & 1, m.hp, 2)

    # --- coefficients ------------------------------------------------
    def coeffs(self, plane: int, x: int, y: int, tx: int,
               vals: np.ndarray, intra_dir: int = 0,
               tx_type: int = recon.DCT_DCT,
               subsampling: tuple = (1, 1), is_inter: bool = False) -> None:
        """Emit one transform block.  vals: (th, tw) int levels (signed),
        zero array means txb_skip."""
        fc = self.fc
        tw, th = T.TX_SIZES_ALL[tx]
        cw, ch = min(tw, 32), min(th, 32)
        ptype = int(plane > 0)
        txs_ctx = T.txsize_entropy_ctx(tx)
        ctx_skip = self._txb_skip_ctx(plane, x, y, tw, th, subsampling)
        coded = vals[:ch, :cw]
        eobmask = coded != 0
        if not eobmask.any():
            self.sym(1, fc.txb_skip[txs_ctx][ctx_skip], 2)
            self._set_ctx(plane, x, y, tw, th, 0, 0, subsampling)
            return
        self.sym(0, fc.txb_skip[txs_ctx][ctx_skip], 2)
        if plane == 0:
            self._write_tx_type(tx, intra_dir, tx_type, is_inter)
        tx_class = T._TX_CLASS.get(tx_type, T.TX_CLASS_2D)
        scan = T.get_scan(tx, tx_type)
        # find eob in scan order
        eob = 0
        for si in range(len(scan)):
            rr, cc = int(scan[si][0]), int(scan[si][1])
            if coded[rr, cc]:
                eob = si + 1
        # eob_pt
        eob_size = cw * ch
        eob_cdf = fc.eob_pt[eob_size]
        emctx = 0 if tx_class == T.TX_CLASS_2D else 1
        t = _eob_pt(eob)
        nsyms = eob_cdf.shape[-1] - 1
        self.sym(t - 1, eob_cdf[ptype][emctx], nsyms)
        if t >= 3:
            offset = eob - (1 << (t - 2)) - 1
            extra = (offset >> (t - 3)) & 1
            self.sym(extra, fc.eob_extra[txs_ctx][ptype][t - 3], 2)
            for i in range(1, t - 2):
                self.literal((offset >> (t - 3 - i)) & 1, 1)
        # reverse scan: base + br
        levels = np.zeros((ch + 4, cw + 4), np.int32)
        bwl = cw.bit_length() - 1
        for si in range(eob - 1, -1, -1):
            rr, cc = int(scan[si][0]), int(scan[si][1])
            lvl = abs(int(coded[rr, cc]))
            if si == eob - 1:
                assert lvl >= 1
                cec = T._base_eob_ctx(si, cw, ch)
                self.sym(min(lvl, 3) - 1,
                         fc.coeff_base_eob[txs_ctx][ptype][cec], 3)
            else:
                tw_full, th_full = T.TX_SIZES_ALL[tx]
                bctx = T._base_ctx(levels, rr, cc, si, bwl, tx_class,
                                   tw_full, th_full)
                self.sym(min(lvl, 3), fc.coeff_base[txs_ctx][ptype][bctx], 4)
            if lvl > 2:
                brctx = T._br_ctx(levels, rr, cc, si, tx_class)
                rem = min(lvl, 15) - 3
                for _ in range(4):
                    k = min(rem, 3)
                    self.sym(k, fc.coeff_br[min(txs_ctx, 3)][ptype][brctx],
                             4)
                    rem -= k
                    if k < 3:
                        break
            levels[rr, cc] = min(lvl, 127)
        # forward: signs + golomb
        cul = 0
        dcsign = 0
        for si in range(eob):
            rr, cc = int(scan[si][0]), int(scan[si][1])
            v = int(coded[rr, cc])
            if v == 0:
                continue
            sign = 1 if v < 0 else 0
            lvl = abs(v)
            if si == 0:
                sctx = self._dc_sign_ctx(plane, x, y, tw, th, subsampling)
                self.sym(sign, fc.dc_sign[ptype][sctx], 2)
                dcsign = -1 if sign else 1
            else:
                self.literal(sign, 1)
            if lvl > 14:
                _write_golomb(self, lvl - 15)
            cul += lvl
        self._set_ctx(plane, x, y, tw, th, min(cul, 63), dcsign,
                      subsampling)

    def _write_tx_type(self, tx, intra_dir, tx_type, is_inter=False):
        sq_up = T.tx_size_sqr_up(tx)
        if self.base_q_idx == 0 or sq_up > (3 if is_inter else 2):
            assert tx_type == recon.DCT_DCT
            return
        sqr = T.tx_size_sqr(tx)
        if is_inter:
            # spec get_tx_set (inter): 32x32-square -> {IDTX, DCT},
            # 16x16-square -> 12-type set, smaller -> all 16
            if self.reduced_tx_set or sq_up == 3:
                txset, set_idx = T.EXT_TX_SET_DCT_IDTX, 3
            elif sqr == 2:
                txset, set_idx = T.EXT_TX_SET_DTT9_IDTX_1DDCT, 2
            else:
                txset, set_idx = T.EXT_TX_SET_ALL16, 1
            self.sym(txset.index(tx_type),
                     self.fc.inter_ext_tx[set_idx][sqr], len(txset))
            return
        # intra sets: 16x16-square (or reduced) -> DTT4_IDTX (5),
        # smaller -> DTT4_IDTX_1DDCT (7)
        if self.reduced_tx_set or sqr == 2:
            txset = T.EXT_TX_SET_DTT4_IDTX
            set_idx = 2
        else:
            txset = T.EXT_TX_SET_DTT4_IDTX_1DDCT
            set_idx = 1
        sym = txset.index(tx_type)
        self.sym(sym, self.fc.intra_ext_tx[set_idx][sqr][intra_dir],
                 len(txset))

    def _txb_skip_ctx(self, plane, x, y, tw, th, ss):
        ssx = ss[0] if plane else 0
        ssy = ss[1] if plane else 0
        c4 = (x >> 2) << ssx
        r4 = (y >> 2) << ssy
        w4 = (tw >> 2) << ssx
        h4 = (th >> 2) << ssy
        a = self.above_levels[plane][c4:c4 + w4]
        lr = r4 % self.sb4
        ll = self.left_levels[plane][lr:lr + h4]
        if plane == 0:
            bsize = int(self.mi_size[min(y >> 2, self.mi_rows - 1),
                                     min(x >> 2, self.mi_cols - 1)])
            bw4, bh4 = T.BLOCK_SIZES[bsize]
            if bw4 * 4 == tw and bh4 * 4 == th:
                return 0
            top = int(min(a.max(initial=0), 4))
            left = int(min(ll.max(initial=0), 4))
            mx = min(top | left, 4)
            mn = min(min(top, left), 4)
            return int(T._SKIP_CONTEXTS[mn][mx])
        above_nz = int((a != 0).any())
        left_nz = int((ll != 0).any())
        bsize = int(self.mi_size[min((y << ssy) >> 2, self.mi_rows - 1),
                                 min((x << ssx) >> 2, self.mi_cols - 1)])
        bw4, bh4 = T.BLOCK_SIZES[bsize]
        cbw = max(bw4 >> ssx, 1) * 4
        cbh = max(bh4 >> ssy, 1) * 4
        offset = 7 if (cbw * cbh <= tw * th) else 10
        return offset + above_nz + left_nz

    def _dc_sign_ctx(self, plane, x, y, tw, th, ss):
        ssx = ss[0] if plane else 0
        ssy = ss[1] if plane else 0
        c4 = (x >> 2) << ssx
        r4 = (y >> 2) << ssy
        w4 = (tw >> 2) << ssx
        h4 = (th >> 2) << ssy
        s = int(self.above_dcsign[plane][c4:c4 + w4].sum())
        lr = r4 % self.sb4
        s += int(self.left_dcsign[plane][lr:lr + h4].sum())
        return 1 if s < 0 else (2 if s > 0 else 0)

    def _set_ctx(self, plane, x, y, tw, th, cul, dcsign, ss):
        ssx = ss[0] if plane else 0
        ssy = ss[1] if plane else 0
        c4 = (x >> 2) << ssx
        r4 = (y >> 2) << ssy
        w4 = (tw >> 2) << ssx
        h4 = (th >> 2) << ssy
        self.above_levels[plane][c4:c4 + w4] = cul
        self.above_dcsign[plane][c4:c4 + w4] = dcsign
        lr = r4 % self.sb4
        self.left_levels[plane][lr:lr + h4] = cul
        self.left_dcsign[plane][lr:lr + h4] = dcsign

    def finish(self) -> bytes:
        buf = ctypes.create_string_buffer(1 << 20)
        sz = self.lib.ec_enc_done(self.enc, buf, 1 << 20)
        self.lib.ec_enc_destroy(self.enc)
        self.enc = None
        return buf.raw[:sz]


def _eob_pt(eob: int) -> int:
    """Inverse of the eob_pt mapping: group index t (1-based)."""
    if eob <= 2:
        return eob
    return (eob - 1).bit_length() + 1


def _write_golomb(tw: TileWriter, value: int) -> None:
    x = value + 1
    length = x.bit_length()
    for _ in range(length - 1):
        tw.literal(0, 1)
    tw.literal(1, 1)
    for i in range(length - 2, -1, -1):
        tw.literal((x >> i) & 1, 1)


def assemble_keyframe(w: int, h: int, qidx: int, tile_data: bytes,
                      seq_kw: dict | None = None, **hdr_kw) -> bytes:
    """TD + sequence header + frame OBU for a single-tile key frame."""
    hdr = write_key_frame_header(w, h, qidx, **hdr_kw)
    hdr.byte_align()
    return obu_mod.temporal_delimiter() + \
        write_sequence_header(w, h, **(seq_kw or {})) + \
        obu_mod.make_obu(obu_mod.OBU_FRAME, hdr.tobytes() + tile_data)
