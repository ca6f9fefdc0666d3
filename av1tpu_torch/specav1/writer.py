# Copied from av1tpu/specav1/writer.py (sequence/frame headers and tile
# group assembly; the tile symbols come from specav1/native.py).
"""Spec-AV1 bitstream writer: sequence and frame headers, tile rows
and the tile group.

The write-side dual of the decoder's header parser
(``specav1/headers.py``).  Tile symbols are emitted by the native
tile writer (``specav1/native.py``).
"""

from __future__ import annotations

from av1tpu_torch.specav1 import obu as obu_mod
from av1tpu_torch.specav1.bits import BitWriter


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
