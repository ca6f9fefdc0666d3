"""A plain reference of AV1's single-reference motion vector stack.

Written from the AV1 bitstream specification's pseudo-code (section
7.10.2, "Find MV stack process", with 7.10.2.12, "Extra search process")
and from uncompressed_header()'s derivation of RefFrameSignBias (5.9.2),
for the syntax an encoder that codes one reference a block uses:
single-reference blocks (isCompound 0), identity global motion,
use_ref_frame_mvs 0 (no temporal candidates), one tile column.  It is
plain Python on integers and shares nothing with any encoder or decoder:
tests hold implementations of the stack to it.

The frame's mode info is a ``ModeInfo``: for each 4x4 unit (mi) that has
been decoded, its block's reference frame (0 intra), motion vector,
size in mi units and whether its mode codes a new vector; ``None`` for a
unit not yet decoded in this frame.
"""

from __future__ import annotations

NONE = -1
INTRA_FRAME = 0
LAST_FRAME = 1
GOLDEN_FRAME = 4
ALTREF_FRAME = 7
REFS_PER_FRAME = 7

MAX_REF_MV_STACK_SIZE = 8
REF_CAT_LEVEL = 640
MI_SIZE = 4
MV_BORDER = 128


def get_relative_dist(a: int, b: int, order_hint_bits: int = 7,
                      enable_order_hint: bool = True) -> int:
    """get_relative_dist( a, b ) of section 7.12.2."""
    if not enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (order_hint_bits - 1)
    diff = (diff & (m - 1)) - (diff & m)
    return diff


def ref_frame_sign_bias(order_hint: int, ref_order_hint, ref_frame_idx,
                        order_hint_bits: int = 7,
                        enable_order_hint: bool = True) -> list:
    """RefFrameSignBias[ LAST_FRAME .. ALTREF_FRAME ] as uncompressed_header
    sets it for an inter frame: for i = 0..REFS_PER_FRAME-1, refFrame =
    LAST_FRAME + i, hint = RefOrderHint[ ref_frame_idx[ i ] ], and the
    bias is get_relative_dist( hint, OrderHint ) > 0.  Index 0 (intra) is
    0."""
    bias = [0] * (ALTREF_FRAME + 1)
    for i in range(REFS_PER_FRAME):
        ref_frame = LAST_FRAME + i
        hint = ref_order_hint[ref_frame_idx[i]]
        if enable_order_hint:
            bias[ref_frame] = int(get_relative_dist(
                hint, order_hint, order_hint_bits) > 0)
    return bias


class ModeInfo:
    """The decoded frame's per-mi mode info: ``ref_frame[r][c]`` (None
    until decoded; 0 intra), ``mv[r][c]`` (row, col) in 1/8 samples,
    ``size[r][c]`` (width, height) of the block in mi units, and
    ``new_mv[r][c]``, whether the block's mode codes a new vector."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows, self.mi_cols = mi_rows, mi_cols
        self.ref_frame = [[None] * mi_cols for _ in range(mi_rows)]
        self.mv = [[(0, 0)] * mi_cols for _ in range(mi_rows)]
        self.size = [[(0, 0)] * mi_cols for _ in range(mi_rows)]
        self.new_mv = [[False] * mi_cols for _ in range(mi_rows)]

    def decode_block(self, mi_row: int, mi_col: int, w4: int, h4: int,
                     ref_frame: int, mv=(0, 0), new_mv=False) -> None:
        """Stores a decoded block over the units inside the frame."""
        for r in range(mi_row, min(mi_row + h4, self.mi_rows)):
            for c in range(mi_col, min(mi_col + w4, self.mi_cols)):
                self.ref_frame[r][c] = ref_frame
                self.mv[r][c] = tuple(mv)
                self.size[r][c] = (w4, h4)
                self.new_mv[r][c] = bool(new_mv)


class MvStack:
    """What the process leaves: ``num_mv_found``, ``ref_stack_mv`` (the
    clamped candidates), ``weight_stack``, ``new_mv_context``,
    ``ref_mv_context``, ``zero_mv_context``, ``drl_ctx_stack`` and
    ``flips`` (the extra search's candidates negated for their sign
    bias)."""

    def __init__(self):
        self.num_mv_found = 0
        self.new_mv_count = 0
        self.ref_stack_mv: list = []
        self.weight_stack: list = []
        self.found_match = 0
        self.new_mv_context = 0
        self.ref_mv_context = 0
        self.zero_mv_context = 0
        self.drl_ctx_stack: list = []
        self.flips = 0


def find_mv_stack(mi: ModeInfo, mi_row: int, mi_col: int, bw4: int,
                  bh4: int, ref_frame: int, sign_bias,
                  tile=None, allow_high_precision_mv: bool = False
                  ) -> MvStack:
    """The find MV stack process (7.10.2) for a single-reference block of
    bw4 x bh4 mi at (mi_row, mi_col) predicting from ``ref_frame``;
    ``sign_bias``: RefFrameSignBias by reference frame; ``tile``:
    (MiRowStart, MiRowEnd, MiColStart, MiColEnd), the frame by default."""
    row_start, row_end, col_start, col_end = tile or (
        0, mi.mi_rows, 0, mi.mi_cols)
    st = MvStack()

    def is_inside(cand_r, cand_c):
        return (col_start <= cand_c < col_end
                and row_start <= cand_r < row_end)

    def lower_mv_precision(mv):
        if allow_high_precision_mv:
            return mv
        out = []
        for v in mv:
            if v & 1:
                v += -1 if v > 0 else 1
            out.append(v)
        return tuple(out)

    def search_stack(mv_row, mv_col, weight):
        # identity global motion: a GLOBALMV neighbour's stored vector
        cand_mv = lower_mv_precision(mi.mv[mv_row][mv_col])
        if mi.new_mv[mv_row][mv_col]:
            st.new_mv_count += 1
        st.found_match = 1
        for idx in range(st.num_mv_found):
            if cand_mv == st.ref_stack_mv[idx]:
                st.weight_stack[idx] += weight
                return
        if st.num_mv_found < MAX_REF_MV_STACK_SIZE:
            st.ref_stack_mv.append(cand_mv)
            st.weight_stack.append(weight)
            st.num_mv_found += 1

    def add_ref_mv_candidate(mv_row, mv_col, weight):
        cand = mi.ref_frame[mv_row][mv_col]
        if cand is None or cand <= INTRA_FRAME:   # IsInters == 0
            return
        if cand == ref_frame:                      # candList 0
            search_stack(mv_row, mv_col, weight)

    def scan_row(delta_row):
        end4 = min(min(bw4, mi.mi_cols - mi_col), 16)
        delta_col = 0
        use_step16 = bw4 >= 16
        if abs(delta_row) > 1:
            delta_row += mi_row & 1
            delta_col = 1 - (mi_col & 1)
        i = 0
        while i < end4:
            mv_row = mi_row + delta_row
            mv_col = mi_col + delta_col + i
            if not is_inside(mv_row, mv_col):
                break
            length = min(bw4, mi.size[mv_row][mv_col][0])
            if abs(delta_row) > 1:
                length = max(2, length)
            if use_step16:
                length = max(4, length)
            add_ref_mv_candidate(mv_row, mv_col, length * 2)
            i += length

    def scan_col(delta_col):
        end4 = min(min(bh4, mi.mi_rows - mi_row), 16)
        delta_row = 0
        use_step16 = bh4 >= 16
        if abs(delta_col) > 1:
            delta_row = 1 - (mi_row & 1)
            delta_col += mi_col & 1
        i = 0
        while i < end4:
            mv_row = mi_row + delta_row + i
            mv_col = mi_col + delta_col
            if not is_inside(mv_row, mv_col):
                break
            length = min(bh4, mi.size[mv_row][mv_col][1])
            if abs(delta_col) > 1:
                length = max(2, length)
            if use_step16:
                length = max(4, length)
            add_ref_mv_candidate(mv_row, mv_col, length * 2)
            i += length

    def scan_point(delta_row, delta_col):
        mv_row, mv_col = mi_row + delta_row, mi_col + delta_col
        if is_inside(mv_row, mv_col) and \
                mi.ref_frame[mv_row][mv_col] is not None:
            add_ref_mv_candidate(mv_row, mv_col, 4)

    def sorting(start, end):
        while end > start:
            new_end = start
            for idx in range(start + 1, end):
                if st.weight_stack[idx - 1] < st.weight_stack[idx]:
                    w, m = st.weight_stack, st.ref_stack_mv
                    w[idx - 1], w[idx] = w[idx], w[idx - 1]
                    m[idx - 1], m[idx] = m[idx], m[idx - 1]
                    new_end = idx
            end = new_end

    def add_extra_mv_candidate(mv_row, mv_col):
        cand_ref = mi.ref_frame[mv_row][mv_col]
        if cand_ref is None or cand_ref <= INTRA_FRAME:
            return
        cand_mv = mi.mv[mv_row][mv_col]
        if sign_bias[cand_ref] != sign_bias[ref_frame]:
            cand_mv = (-cand_mv[0], -cand_mv[1])
            st.flips += 1
        for idx in range(st.num_mv_found):
            if cand_mv == st.ref_stack_mv[idx]:
                return
        st.ref_stack_mv.append(cand_mv)
        st.weight_stack.append(2)
        st.num_mv_found += 1

    def extra_search():
        w4 = min(16, bw4)
        h4 = min(16, bh4)
        w4 = min(w4, mi.mi_cols - mi_col)
        h4 = min(h4, mi.mi_rows - mi_row)
        num4x4 = min(w4, h4)
        for pass_ in range(2):
            if st.num_mv_found >= 2:
                break
            idx = 0
            while idx < num4x4 and st.num_mv_found < 2:
                if pass_ == 0:
                    mv_row, mv_col = mi_row - 1, mi_col + idx
                else:
                    mv_row, mv_col = mi_row + idx, mi_col - 1
                if not is_inside(mv_row, mv_col):
                    break
                add_extra_mv_candidate(mv_row, mv_col)
                size = mi.size[mv_row][mv_col]
                idx += size[0] if pass_ == 0 else size[1]

    def clamp_mv_row(v, border):
        to_top = -((mi_row * MI_SIZE) * 8)
        to_bottom = ((mi.mi_rows - bh4 - mi_row) * MI_SIZE) * 8
        return min(max(v, to_top - border), to_bottom + border)

    def clamp_mv_col(v, border):
        to_left = -((mi_col * MI_SIZE) * 8)
        to_right = ((mi.mi_cols - bw4 - mi_col) * MI_SIZE) * 8
        return min(max(v, to_left - border), to_right + border)

    # 7.10.2.1
    st.found_match = 0
    scan_row(-1)
    found_above_match = st.found_match
    st.found_match = 0
    scan_col(-1)
    found_left_match = st.found_match
    st.found_match = 0
    if max(bw4, bh4) <= 16:
        scan_point(-1, bw4)
    if st.found_match:
        found_above_match = 1
    close_matches = found_above_match + found_left_match
    num_nearest = st.num_mv_found
    num_new = st.new_mv_count
    for idx in range(num_nearest):
        st.weight_stack[idx] += REF_CAT_LEVEL
    st.zero_mv_context = 0
    st.found_match = 0
    scan_point(-1, -1)
    if st.found_match:
        found_above_match = 1
    st.found_match = 0
    scan_row(-3)
    if st.found_match:
        found_above_match = 1
    st.found_match = 0
    scan_col(-3)
    if st.found_match:
        found_left_match = 1
    st.found_match = 0
    if bh4 > 1:
        scan_row(-5)
    if st.found_match:
        found_above_match = 1
    st.found_match = 0
    if bw4 > 1:
        scan_col(-5)
    if st.found_match:
        found_left_match = 1
    total_matches = found_above_match + found_left_match
    sorting(0, num_nearest)
    sorting(num_nearest, st.num_mv_found)
    if st.num_mv_found < 2:
        extra_search()
    # 7.10.2.14, context and clamping
    for idx in range(st.num_mv_found):
        z = 0
        if idx + 1 < st.num_mv_found:
            w0, w1 = st.weight_stack[idx], st.weight_stack[idx + 1]
            if w0 >= REF_CAT_LEVEL:
                if w1 < REF_CAT_LEVEL:
                    z = 1
            else:
                z = 2
        st.drl_ctx_stack.append(z)
    st.ref_stack_mv = [
        (clamp_mv_row(r, MV_BORDER + bh4 * 4 * 8),
         clamp_mv_col(c, MV_BORDER + bw4 * 4 * 8))
        for r, c in st.ref_stack_mv]
    if close_matches == 0:
        st.new_mv_context = min(total_matches, 1)
        st.ref_mv_context = total_matches
    elif close_matches == 1:
        st.new_mv_context = 3 - min(num_new, 1)
        st.ref_mv_context = 2 + total_matches
    else:
        st.new_mv_context = 5 - min(num_new, 1)
        st.ref_mv_context = 5
    return st
