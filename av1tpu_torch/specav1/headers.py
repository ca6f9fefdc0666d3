# Copied from av1tpu/specav1/headers.py.
"""AV1 sequence + frame header syntax (spec §5.5, §5.9), parse and state.

Implements uncompressed_header() faithfully enough to decode libaom-
produced streams: key and inter frames, tile info, quantization,
segmentation, delta-q/lf, loop filter, CDEF, loop restoration, tx mode,
reference mode, skip mode, global motion, film grain presence.

The parse mirrors the spec's pseudocode function-for-function so a
symbol-level desync can be localized during conformance work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from av1tpu_torch.specav1.bits import BitReader

# frame types
KEY_FRAME = 0
INTER_FRAME = 1
INTRA_ONLY_FRAME = 2
SWITCH_FRAME = 3

NUM_REF_FRAMES = 8
REFS_PER_FRAME = 7
PRIMARY_REF_NONE = 7
SUPERRES_DENOM_BITS = 3
SUPERRES_DENOM_MIN = 9
SUPERRES_NUM = 8
MAX_SEGMENTS = 8
SEG_LVL_MAX = 8
SEG_LVL_ALT_Q = 0
SEG_LVL_REF_FRAME = 5
SEG_LVL_SKIP = 6
SEG_LVL_GLOBALMV = 7
TX_MODES = ("ONLY_4X4", "TX_MODE_LARGEST", "TX_MODE_SELECT")

RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)

# global motion types
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = range(4)

_SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
_SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
_SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


@dataclass
class SequenceHeader:
    seq_profile: int = 0
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    seq_level_idx: int = 0
    timing_info_present: int = 0
    decoder_model_info_present: int = 0
    initial_display_delay_present: int = 0
    operating_points_cnt_minus_1: int = 0
    frame_width_bits: int = 16
    frame_height_bits: int = 16
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: int = 0
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: int = 0
    enable_filter_intra: int = 0
    enable_intra_edge_filter: int = 0
    enable_interintra_compound: int = 0
    enable_masked_compound: int = 0
    enable_warped_motion: int = 0
    enable_dual_filter: int = 0
    enable_order_hint: int = 0
    enable_jnt_comp: int = 0
    enable_ref_frame_mvs: int = 0
    seq_force_screen_content_tools: int = 0
    seq_force_integer_mv: int = 0
    order_hint_bits: int = 0
    enable_superres: int = 0
    enable_cdef: int = 0
    enable_restoration: int = 0
    # color_config
    high_bitdepth: int = 0
    twelve_bit: int = 0
    bit_depth: int = 8
    mono_chrome: int = 0
    color_description_present: int = 0
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: int = 0
    film_grain_params_present: int = 0


SELECT_SCREEN_CONTENT_TOOLS = 2
SELECT_INTEGER_MV = 2


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    b = BitReader(payload)
    s = SequenceHeader()
    s.seq_profile = b.f(3)
    s.still_picture = b.f(1)
    s.reduced_still_picture_header = b.f(1)
    if s.reduced_still_picture_header:
        s.seq_level_idx = b.f(5)
        s.seq_force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS
        s.seq_force_integer_mv = SELECT_INTEGER_MV
    else:
        s.timing_info_present = b.f(1)
        if s.timing_info_present:
            # timing_info()
            b.f(32)  # num_units_in_display_tick
            b.f(32)  # time_scale
            if b.f(1):  # equal_picture_interval
                b.uvlc()  # num_ticks_per_picture_minus_1
            s.decoder_model_info_present = b.f(1)
            if s.decoder_model_info_present:
                raise NotImplementedError("decoder_model_info")
        s.initial_display_delay_present = b.f(1)
        s.operating_points_cnt_minus_1 = b.f(5)
        for _ in range(s.operating_points_cnt_minus_1 + 1):
            b.f(12)  # operating_point_idc
            level = b.f(5)
            s.seq_level_idx = level
            if level > 7:
                b.f(1)  # seq_tier
            if s.initial_display_delay_present:
                if b.f(1):
                    b.f(4)
    s.frame_width_bits = b.f(4) + 1
    s.frame_height_bits = b.f(4) + 1
    s.max_frame_width = b.f(s.frame_width_bits) + 1
    s.max_frame_height = b.f(s.frame_height_bits) + 1
    if not s.reduced_still_picture_header:
        s.frame_id_numbers_present = b.f(1)
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = b.f(4) + 2
        s.additional_frame_id_length = b.f(3) + 1
    s.use_128x128_superblock = b.f(1)
    s.enable_filter_intra = b.f(1)
    s.enable_intra_edge_filter = b.f(1)
    if not s.reduced_still_picture_header:
        s.enable_interintra_compound = b.f(1)
        s.enable_masked_compound = b.f(1)
        s.enable_warped_motion = b.f(1)
        s.enable_dual_filter = b.f(1)
        s.enable_order_hint = b.f(1)
        if s.enable_order_hint:
            s.enable_jnt_comp = b.f(1)
            s.enable_ref_frame_mvs = b.f(1)
        if b.f(1):  # seq_choose_screen_content_tools
            s.seq_force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS
        else:
            s.seq_force_screen_content_tools = b.f(1)
        if s.seq_force_screen_content_tools > 0:
            if b.f(1):  # seq_choose_integer_mv
                s.seq_force_integer_mv = SELECT_INTEGER_MV
            else:
                s.seq_force_integer_mv = b.f(1)
        else:
            s.seq_force_integer_mv = SELECT_INTEGER_MV
        if s.enable_order_hint:
            s.order_hint_bits = b.f(3) + 1
    s.enable_superres = b.f(1)
    s.enable_cdef = b.f(1)
    s.enable_restoration = b.f(1)
    _parse_color_config(b, s)
    s.film_grain_params_present = b.f(1)
    return s


def _parse_color_config(b: BitReader, s: SequenceHeader) -> None:
    s.high_bitdepth = b.f(1)
    if s.seq_profile == 2 and s.high_bitdepth:
        s.twelve_bit = b.f(1)
        s.bit_depth = 12 if s.twelve_bit else 10
    else:
        s.bit_depth = 10 if s.high_bitdepth else 8
    if s.seq_profile != 1:
        s.mono_chrome = b.f(1)
    s.color_description_present = b.f(1)
    if s.color_description_present:
        s.color_primaries = b.f(8)
        s.transfer_characteristics = b.f(8)
        s.matrix_coefficients = b.f(8)
    if s.mono_chrome:
        s.color_range = b.f(1)
        s.subsampling_x = s.subsampling_y = 1
        s.chroma_sample_position = 0
        s.separate_uv_delta_q = 0
        return
    if (s.color_primaries == 1 and s.transfer_characteristics == 13
            and s.matrix_coefficients == 0):
        s.color_range = 1
        s.subsampling_x = s.subsampling_y = 0
    else:
        s.color_range = b.f(1)
        if s.seq_profile == 0:
            s.subsampling_x = s.subsampling_y = 1
        elif s.seq_profile == 1:
            s.subsampling_x = s.subsampling_y = 0
        else:
            if s.bit_depth == 12:
                s.subsampling_x = b.f(1)
                s.subsampling_y = b.f(1) if s.subsampling_x else 0
            else:
                s.subsampling_x, s.subsampling_y = 1, 0
        if s.subsampling_x and s.subsampling_y:
            s.chroma_sample_position = b.f(2)
    s.separate_uv_delta_q = b.f(1)


# ---------------------------------------------------------------------------
# frame header
# ---------------------------------------------------------------------------

@dataclass
class LoopFilterParams:
    level: list = field(default_factory=lambda: [0, 0, 0, 0])
    sharpness: int = 0
    delta_enabled: int = 0
    ref_deltas: list = field(
        default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    mode_deltas: list = field(default_factory=lambda: [0, 0])


@dataclass
class CdefParams:
    damping: int = 3
    bits: int = 0
    y_pri: list = field(default_factory=lambda: [0] * 8)
    y_sec: list = field(default_factory=lambda: [0] * 8)
    uv_pri: list = field(default_factory=lambda: [0] * 8)
    uv_sec: list = field(default_factory=lambda: [0] * 8)


@dataclass
class LrParams:
    frame_restoration_type: list = field(default_factory=lambda: [0, 0, 0])
    loop_restoration_size: list = field(
        default_factory=lambda: [256, 256, 256])
    uses_lr: bool = False


@dataclass
class FrameHeader:
    show_existing_frame: int = 0
    frame_to_show_map_idx: int = 0
    frame_type: int = KEY_FRAME
    show_frame: int = 1
    showable_frame: int = 0
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 0
    frame_size_override: int = 0
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    frame_width: int = 0
    frame_height: int = 0
    upscaled_width: int = 0
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = SUPERRES_NUM
    allow_intrabc: int = 0
    ref_frame_idx: list = field(default_factory=lambda: [0] * 7)
    allow_high_precision_mv: int = 0
    interpolation_filter: int = 0
    is_filter_switchable: int = 0
    is_motion_mode_switchable: int = 0
    use_ref_frame_mvs: int = 0
    disable_frame_end_update_cdf: int = 0
    # tile info
    tile_cols: int = 1
    tile_rows: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    mi_col_starts: list = field(default_factory=list)
    mi_row_starts: list = field(default_factory=list)
    context_update_tile_id: int = 0
    tile_size_bytes: int = 1
    # quantization
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: int = 0
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0
    # segmentation
    segmentation_enabled: int = 0
    segmentation_update_map: int = 0
    segmentation_temporal_update: int = 0
    feature_enabled: list = field(
        default_factory=lambda: [[0] * SEG_LVL_MAX
                                 for _ in range(MAX_SEGMENTS)])
    feature_data: list = field(
        default_factory=lambda: [[0] * SEG_LVL_MAX
                                 for _ in range(MAX_SEGMENTS)])
    seg_id_pre_skip: int = 0
    last_active_seg_id: int = 0
    # deltas
    delta_q_present: int = 0
    delta_q_res: int = 0
    delta_lf_present: int = 0
    delta_lf_res: int = 0
    delta_lf_multi: int = 0
    # computed lossless
    coded_lossless: int = 0
    all_lossless: int = 0
    lossless_array: list = field(default_factory=lambda: [0] * MAX_SEGMENTS)
    lf: LoopFilterParams = field(default_factory=LoopFilterParams)
    cdef: CdefParams = field(default_factory=CdefParams)
    lr: LrParams = field(default_factory=LrParams)
    tx_mode_select: int = 0
    tx_mode: str = "TX_MODE_LARGEST"
    reference_select: int = 0
    skip_mode_present: int = 0
    allow_warped_motion: int = 0
    reduced_tx_set: int = 0
    gm_type: list = field(default_factory=lambda: [IDENTITY] * 8)
    gm_params: list = field(
        default_factory=lambda: [[0, 0, 1 << 16, 0, 0, 1 << 16]
                                 for _ in range(8)])
    # sizes in mode-info (4x4) units
    mi_cols: int = 0
    mi_rows: int = 0
    header_bits: int = 0  # bit position where the header ended

    def frame_is_intra(self) -> bool:
        return self.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)


def _read_delta_q(b: BitReader) -> int:
    if b.f(1):
        return b.su(7)
    return 0


def parse_frame_header(payload: bytes, seq: SequenceHeader,
                       pos_bits: int = 0) -> FrameHeader:
    """Parse uncompressed_header(); returns header with header_bits set
    to the position just after (before byte_alignment for OBU_FRAME)."""
    b = BitReader(payload, pos_bits)
    h = FrameHeader()
    id_len = seq.delta_frame_id_length + seq.additional_frame_id_length
    if seq.reduced_still_picture_header:
        h.frame_type = KEY_FRAME
        h.show_frame = 1
        frame_is_intra = True
    else:
        h.show_existing_frame = b.f(1)
        if h.show_existing_frame:
            h.frame_to_show_map_idx = b.f(3)
            if seq.frame_id_numbers_present:
                b.f(id_len)  # display_frame_id
            h.header_bits = b.pos
            return h
        h.frame_type = b.f(2)
        frame_is_intra = h.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)
        h.show_frame = b.f(1)
        if h.show_frame:
            h.showable_frame = int(h.frame_type != KEY_FRAME)
        else:
            h.showable_frame = b.f(1)
        if h.frame_type == SWITCH_FRAME or \
                (h.frame_type == KEY_FRAME and h.show_frame):
            h.error_resilient_mode = 1
        else:
            h.error_resilient_mode = b.f(1)
    h.disable_cdf_update = b.f(1)
    if seq.seq_force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS:
        h.allow_screen_content_tools = b.f(1)
    else:
        h.allow_screen_content_tools = seq.seq_force_screen_content_tools
    if h.allow_screen_content_tools:
        if seq.seq_force_integer_mv == SELECT_INTEGER_MV:
            h.force_integer_mv = b.f(1)
        else:
            h.force_integer_mv = seq.seq_force_integer_mv
    else:
        h.force_integer_mv = 0
    if frame_is_intra:
        h.force_integer_mv = 1
    if seq.frame_id_numbers_present:
        b.f(id_len)  # current_frame_id
    if not seq.reduced_still_picture_header:
        if h.frame_type == SWITCH_FRAME:
            h.frame_size_override = 1
        else:
            h.frame_size_override = b.f(1)
        if seq.enable_order_hint:
            h.order_hint = b.f(seq.order_hint_bits)
        if frame_is_intra or h.error_resilient_mode:
            h.primary_ref_frame = PRIMARY_REF_NONE
        else:
            h.primary_ref_frame = b.f(3)
    allow_intrabc = 0
    if h.frame_type == KEY_FRAME:
        if not h.show_frame:
            h.refresh_frame_flags = b.f(8)
        else:
            h.refresh_frame_flags = 0xFF
        _frame_size(b, seq, h)
        _render_size(b, h)
        if h.allow_screen_content_tools and \
                h.upscaled_width == h.frame_width:
            allow_intrabc = b.f(1)
    elif h.frame_type == INTRA_ONLY_FRAME:
        h.refresh_frame_flags = b.f(8)
        _frame_size(b, seq, h)
        _render_size(b, h)
        if h.allow_screen_content_tools and \
                h.upscaled_width == h.frame_width:
            allow_intrabc = b.f(1)
    else:
        if h.frame_type == SWITCH_FRAME:
            h.refresh_frame_flags = 0xFF
        else:
            h.refresh_frame_flags = b.f(8)
        if h.error_resilient_mode and seq.enable_order_hint:
            for _ in range(NUM_REF_FRAMES):
                b.f(seq.order_hint_bits)  # ref_order_hint
        frame_refs_short_signaling = 0
        if seq.enable_order_hint:
            frame_refs_short_signaling = b.f(1)
            if frame_refs_short_signaling:
                raise NotImplementedError("frame_refs_short_signaling")
        for i in range(REFS_PER_FRAME):
            if not frame_refs_short_signaling:
                h.ref_frame_idx[i] = b.f(3)
            if seq.frame_id_numbers_present:
                b.f(seq.delta_frame_id_length)  # delta_frame_id_minus_1
        if h.frame_size_override and not h.error_resilient_mode:
            # frame_size_with_refs: found_ref per ref
            found = False
            for _ in range(REFS_PER_FRAME):
                if b.f(1):
                    found = True
                    raise NotImplementedError("size-from-ref")
            if not found:
                _frame_size(b, seq, h)
                _render_size(b, h)
        else:
            _frame_size(b, seq, h)
            _render_size(b, h)
        if h.force_integer_mv:
            h.allow_high_precision_mv = 0
        else:
            h.allow_high_precision_mv = b.f(1)
        # read_interpolation_filter
        h.is_filter_switchable = b.f(1)
        if h.is_filter_switchable:
            h.interpolation_filter = 4  # SWITCHABLE
        else:
            h.interpolation_filter = b.f(2)
        h.is_motion_mode_switchable = b.f(1)
        if h.error_resilient_mode or not seq.enable_ref_frame_mvs:
            h.use_ref_frame_mvs = 0
        else:
            h.use_ref_frame_mvs = b.f(1)
    h.allow_intrabc = allow_intrabc

    if seq.reduced_still_picture_header or h.disable_cdf_update:
        h.disable_frame_end_update_cdf = 1
    else:
        h.disable_frame_end_update_cdf = b.f(1)

    _tile_info(b, seq, h)
    _quantization_params(b, seq, h)
    _segmentation_params(b, h)
    # delta_q_params
    if h.base_q_idx > 0:
        h.delta_q_present = b.f(1)
    if h.delta_q_present:
        h.delta_q_res = b.f(2)
    # delta_lf_params
    if h.delta_q_present:
        if not h.allow_intrabc:
            h.delta_lf_present = b.f(1)
        if h.delta_lf_present:
            h.delta_lf_res = b.f(2)
            h.delta_lf_multi = b.f(1)
    _compute_lossless(h)
    _loop_filter_params(b, seq, h)
    _cdef_params(b, seq, h)
    _lr_params(b, seq, h)
    # read_tx_mode
    if h.coded_lossless:
        h.tx_mode = "ONLY_4X4"
    else:
        h.tx_mode_select = b.f(1)
        h.tx_mode = "TX_MODE_SELECT" if h.tx_mode_select \
            else "TX_MODE_LARGEST"
    # frame_reference_mode
    if frame_is_intra:
        h.reference_select = 0
    else:
        h.reference_select = b.f(1)
    # skip_mode_params
    skip_mode_allowed = 0
    if not (frame_is_intra or not h.reference_select
            or not seq.enable_order_hint or h.error_resilient_mode):
        skip_mode_allowed = 1  # simplified; exact check needs order hints
    if skip_mode_allowed:
        h.skip_mode_present = b.f(1)
    # allow_warped_motion
    if frame_is_intra or h.error_resilient_mode or \
            not seq.enable_warped_motion:
        h.allow_warped_motion = 0
    else:
        h.allow_warped_motion = b.f(1)
    h.reduced_tx_set = b.f(1)
    # global_motion_params
    if not frame_is_intra:
        for ref in range(1, 8):
            is_global = b.f(1)
            gtype = IDENTITY
            if is_global:
                if b.f(1):  # is_rot_zoom
                    gtype = ROTZOOM
                else:
                    gtype = AFFINE if b.f(1) else TRANSLATION
            h.gm_type[ref] = gtype
            if gtype != IDENTITY:
                raise NotImplementedError("non-identity global motion")
    # film_grain_params
    if seq.film_grain_params_present and \
            (h.show_frame or h.showable_frame):
        apply_grain = b.f(1)
        if apply_grain:
            raise NotImplementedError("film grain")
    h.header_bits = b.pos
    return h


def _frame_size(b: BitReader, seq: SequenceHeader, h: FrameHeader) -> None:
    if h.frame_size_override:
        h.frame_width = b.f(seq.frame_width_bits) + 1
        h.frame_height = b.f(seq.frame_height_bits) + 1
    else:
        h.frame_width = seq.max_frame_width
        h.frame_height = seq.max_frame_height
    _superres_params(b, seq, h)
    h.mi_cols = 2 * ((h.frame_width + 7) >> 3)
    h.mi_rows = 2 * ((h.frame_height + 7) >> 3)


def _superres_params(b: BitReader, seq: SequenceHeader,
                     h: FrameHeader) -> None:
    use_superres = b.f(1) if seq.enable_superres else 0
    if use_superres:
        h.superres_denom = b.f(SUPERRES_DENOM_BITS) + SUPERRES_DENOM_MIN
    else:
        h.superres_denom = SUPERRES_NUM
    h.upscaled_width = h.frame_width
    h.frame_width = (h.upscaled_width * SUPERRES_NUM +
                     h.superres_denom // 2) // h.superres_denom


def _render_size(b: BitReader, h: FrameHeader) -> None:
    if b.f(1):
        h.render_width = b.f(16) + 1
        h.render_height = b.f(16) + 1
    else:
        h.render_width = h.upscaled_width
        h.render_height = h.frame_height


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _tile_info(b: BitReader, seq: SequenceHeader, h: FrameHeader) -> None:
    sb_size_log2 = 7 if seq.use_128x128_superblock else 6
    sb_shift = sb_size_log2 - 2
    sb_cols = (h.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (h.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    uniform = b.f(1)
    if uniform:
        log2_cols = min_log2_tile_cols
        while log2_cols < max_log2_tile_cols and b.f(1):
            log2_cols += 1
        tile_width_sb = (sb_cols + (1 << log2_cols) - 1) >> log2_cols
        h.mi_col_starts = list(range(0, sb_cols * (1 << sb_shift) + 1,
                                     tile_width_sb << sb_shift))
        h.mi_col_starts = [min(x, h.mi_cols) for x in h.mi_col_starts]
        # dedupe trailing
        starts = []
        i = 0
        while i * tile_width_sb < sb_cols:
            starts.append(i * tile_width_sb << sb_shift)
            i += 1
        starts.append(h.mi_cols)
        h.mi_col_starts = starts
        h.tile_cols = len(starts) - 1
        h.tile_cols_log2 = log2_cols
        min_log2_tile_rows = max(min_log2_tiles - log2_cols, 0)
        log2_rows = min_log2_tile_rows
        while log2_rows < max_log2_tile_rows and b.f(1):
            log2_rows += 1
        tile_height_sb = (sb_rows + (1 << log2_rows) - 1) >> log2_rows
        starts = []
        i = 0
        while i * tile_height_sb < sb_rows:
            starts.append(i * tile_height_sb << sb_shift)
            i += 1
        starts.append(h.mi_rows)
        h.mi_row_starts = starts
        h.tile_rows = len(starts) - 1
        h.tile_rows_log2 = log2_rows
    else:
        # non-uniform spacing
        widest = 0
        start_sb = 0
        starts = []
        while start_sb < sb_cols:
            starts.append(start_sb << sb_shift)
            max_width = min(sb_cols - start_sb, max_tile_width_sb)
            width_in_sbs = b.ns(max_width) + 1
            widest = max(widest, width_in_sbs)
            start_sb += width_in_sbs
        starts.append(h.mi_cols)
        h.mi_col_starts = starts
        h.tile_cols = len(starts) - 1
        h.tile_cols_log2 = _tile_log2(1, h.tile_cols)
        if min_log2_tiles > 0:
            max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            max_tile_area_sb = sb_rows * sb_cols
        max_tile_height_sb = max(max_tile_area_sb // widest, 1)
        start_sb = 0
        starts = []
        while start_sb < sb_rows:
            starts.append(start_sb << sb_shift)
            max_height = min(sb_rows - start_sb, max_tile_height_sb)
            height_in_sbs = b.ns(max_height) + 1
            start_sb += height_in_sbs
        starts.append(h.mi_rows)
        h.mi_row_starts = starts
        h.tile_rows = len(starts) - 1
        h.tile_rows_log2 = _tile_log2(1, h.tile_rows)
    if h.tile_cols_log2 > 0 or h.tile_rows_log2 > 0:
        h.context_update_tile_id = b.f(h.tile_rows_log2 + h.tile_cols_log2)
        h.tile_size_bytes = b.f(2) + 1
    else:
        h.context_update_tile_id = 0


def _quantization_params(b: BitReader, seq: SequenceHeader,
                         h: FrameHeader) -> None:
    h.base_q_idx = b.f(8)
    h.delta_q_y_dc = _read_delta_q(b)
    if not seq.mono_chrome:
        diff_uv_delta = 0
        if seq.separate_uv_delta_q:
            diff_uv_delta = b.f(1)
        h.delta_q_u_dc = _read_delta_q(b)
        h.delta_q_u_ac = _read_delta_q(b)
        if diff_uv_delta:
            h.delta_q_v_dc = _read_delta_q(b)
            h.delta_q_v_ac = _read_delta_q(b)
        else:
            h.delta_q_v_dc = h.delta_q_u_dc
            h.delta_q_v_ac = h.delta_q_u_ac
    h.using_qmatrix = b.f(1)
    if h.using_qmatrix:
        h.qm_y = b.f(4)
        h.qm_u = b.f(4)
        if not seq.separate_uv_delta_q:
            h.qm_v = h.qm_u
        else:
            h.qm_v = b.f(4)


def _segmentation_params(b: BitReader, h: FrameHeader) -> None:
    h.segmentation_enabled = b.f(1)
    if h.segmentation_enabled:
        if h.primary_ref_frame == PRIMARY_REF_NONE:
            h.segmentation_update_map = 1
            h.segmentation_temporal_update = 0
            update_data = 1
        else:
            h.segmentation_update_map = b.f(1)
            if h.segmentation_update_map:
                h.segmentation_temporal_update = b.f(1)
            update_data = b.f(1)
        if update_data:
            for i in range(MAX_SEGMENTS):
                for j in range(SEG_LVL_MAX):
                    enabled = b.f(1)
                    h.feature_enabled[i][j] = enabled
                    value = 0
                    if enabled:
                        bits = _SEG_FEATURE_BITS[j]
                        limit = _SEG_FEATURE_MAX[j]
                        if _SEG_FEATURE_SIGNED[j]:
                            value = b.su(1 + bits)
                            value = max(-limit, min(limit, value))
                        elif bits:
                            value = min(b.f(bits), limit)
                    h.feature_data[i][j] = value
    for i in range(MAX_SEGMENTS):
        for j in range(SEG_LVL_MAX):
            if h.feature_enabled[i][j]:
                h.last_active_seg_id = i
                if j >= SEG_LVL_REF_FRAME:
                    h.seg_id_pre_skip = 1


def _get_qindex(h: FrameHeader, seg: int) -> int:
    if h.segmentation_enabled and h.feature_enabled[seg][SEG_LVL_ALT_Q]:
        q = h.base_q_idx + h.feature_data[seg][SEG_LVL_ALT_Q]
        return max(0, min(255, q))
    return h.base_q_idx


def _compute_lossless(h: FrameHeader) -> None:
    h.coded_lossless = 1
    for seg in range(MAX_SEGMENTS):
        qindex = _get_qindex(h, seg)
        lossless = int(qindex == 0 and h.delta_q_y_dc == 0 and
                       h.delta_q_u_ac == 0 and h.delta_q_u_dc == 0 and
                       h.delta_q_v_ac == 0 and h.delta_q_v_dc == 0)
        h.lossless_array[seg] = lossless
        if not lossless:
            h.coded_lossless = 0
    h.all_lossless = int(h.coded_lossless and
                         h.frame_width == h.upscaled_width)


def _loop_filter_params(b: BitReader, seq: SequenceHeader,
                        h: FrameHeader) -> None:
    if h.coded_lossless or h.allow_intrabc:
        h.lf = LoopFilterParams()
        h.lf.level = [0, 0, 0, 0]
        return
    lf = h.lf
    lf.level[0] = b.f(6)
    lf.level[1] = b.f(6)
    if not seq.mono_chrome:
        if lf.level[0] or lf.level[1]:
            lf.level[2] = b.f(6)
            lf.level[3] = b.f(6)
    lf.sharpness = b.f(3)
    lf.delta_enabled = b.f(1)
    if lf.delta_enabled:
        if b.f(1):  # delta_update
            for i in range(8):
                if b.f(1):
                    lf.ref_deltas[i] = b.su(7)
            for i in range(2):
                if b.f(1):
                    lf.mode_deltas[i] = b.su(7)


def _cdef_params(b: BitReader, seq: SequenceHeader, h: FrameHeader) -> None:
    if h.coded_lossless or h.allow_intrabc or not seq.enable_cdef:
        h.cdef = CdefParams()
        return
    c = h.cdef
    c.damping = b.f(2) + 3
    c.bits = b.f(2)
    for i in range(1 << c.bits):
        c.y_pri[i] = b.f(4)
        c.y_sec[i] = b.f(2)
        if c.y_sec[i] == 3:
            c.y_sec[i] += 1
        c.uv_pri[i] = b.f(4)
        c.uv_sec[i] = b.f(2)
        if c.uv_sec[i] == 3:
            c.uv_sec[i] += 1


def _lr_params(b: BitReader, seq: SequenceHeader, h: FrameHeader) -> None:
    if h.all_lossless or h.allow_intrabc or not seq.enable_restoration:
        h.lr = LrParams()
        return
    lr = h.lr
    remap = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
             RESTORE_SGRPROJ)
    uses_lr = uses_chroma_lr = False
    num_planes = 1 if seq.mono_chrome else 3
    for i in range(num_planes):
        lr.frame_restoration_type[i] = remap[b.f(2)]
        if lr.frame_restoration_type[i] != RESTORE_NONE:
            uses_lr = True
            if i > 0:
                uses_chroma_lr = True
    lr.uses_lr = uses_lr
    if uses_lr:
        if seq.use_128x128_superblock:
            shift = b.f(1) + 1
        else:
            shift = b.f(1)
            if shift:
                shift += b.f(1)
        lr.loop_restoration_size[0] = 256 >> (2 - shift)
        if seq.subsampling_x and seq.subsampling_y and uses_chroma_lr:
            uv_shift = b.f(1)
        else:
            uv_shift = 0
        lr.loop_restoration_size[1] = \
            lr.loop_restoration_size[0] >> uv_shift
        lr.loop_restoration_size[2] = \
            lr.loop_restoration_size[0] >> uv_shift
