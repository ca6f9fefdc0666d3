# Copied from av1tpu/specav1/mvrefs.py (one departure, marked where it is:
# the frame-edge clamp of the MV candidates).
"""Spec-AV1 motion-vector prediction: the MV stack + mode contexts
(spec §7.10.2 "find MV stack", following libaom's setup_ref_mv_list).

Shared by the tile writer (choosing CDF contexts while emitting) and
the tile decoder — both MUST compute identical results, and both are
behaviorally validated by round-tripping streams through the
independent libaom decoder.

Scope: single-reference prediction, identity global motion, no
temporal MVPs (sequence disables ref_frame_mvs), no compound.  The
unexercised outer-ring scan paths (only reachable with sub-8x8-mi
blocks next to larger neighbours) are implemented per the same rules
but flagged; conformance tests cover the uniform 32x32 grid the
encoder emits plus mixed availability at frame/tile edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
REF_CAT_LEVEL = 640
MVREF_ROW_COLS = 3
MV_BORDER = 16 << 3

# ref frame ids (spec)
NONE_FRAME, INTRA_FRAME = -1, 0
(LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME, BWDREF_FRAME,
 ALTREF2_FRAME, ALTREF_FRAME) = range(1, 8)


@dataclasses.dataclass
class MvGrid:
    """Per-mi-cell mode info for the current (partially coded) frame.

    ref:   int8  (mr, mc); 0 = intra, -1 = not yet coded, 1..7 = ref
    mv_r:  int16 (mr, mc)  1/8-pel
    mv_c:  int16 (mr, mc)
    n4_w:  int8  (mr, mc)  coding-block width in mi units at this cell
    n4_h:  int8  (mr, mc)
    newmv: bool  (mr, mc)  block's mode is NEWMV-class
    """
    ref: np.ndarray
    mv_r: np.ndarray
    mv_c: np.ndarray
    n4_w: np.ndarray
    n4_h: np.ndarray
    newmv: np.ndarray

    @classmethod
    def create(cls, mi_rows: int, mi_cols: int) -> "MvGrid":
        return cls(np.full((mi_rows, mi_cols), -1, np.int8),
                   np.zeros((mi_rows, mi_cols), np.int16),
                   np.zeros((mi_rows, mi_cols), np.int16),
                   np.zeros((mi_rows, mi_cols), np.int8),
                   np.zeros((mi_rows, mi_cols), np.int8),
                   np.zeros((mi_rows, mi_cols), bool))

    def set_block(self, r: int, c: int, h4: int, w4: int, ref: int,
                  mv: tuple, newmv: bool) -> None:
        self.ref[r:r + h4, c:c + w4] = ref
        self.mv_r[r:r + h4, c:c + w4] = mv[0]
        self.mv_c[r:r + h4, c:c + w4] = mv[1]
        self.n4_w[r:r + h4, c:c + w4] = w4
        self.n4_h[r:r + h4, c:c + w4] = h4
        self.newmv[r:r + h4, c:c + w4] = newmv


@dataclasses.dataclass
class MvStackResult:
    mvs: list            # [(row, col)] * num found (clamped)
    weights: list
    num_mv_found: int
    new_mv_ctx: int
    ref_mv_ctx: int
    zero_mv_ctx: int

    def drl_ctx(self, idx: int) -> int:
        w = self.weights
        a = w[idx] >= REF_CAT_LEVEL
        b = (idx + 1 < len(w)) and w[idx + 1] >= REF_CAT_LEVEL
        if a and b:
            return 0
        if a and not b:
            return 1
        if not a and not b:
            return 2
        return 0

    def ref_mv(self, idx: int) -> tuple:
        """Stack entry, padded with the (identity) global mv."""
        if idx < self.num_mv_found:
            return self.mvs[idx]
        return (0, 0)


def _has_top_right(mi_row: int, mi_col: int, bw4: int, bh4: int,
                   sb_mi: int = 16) -> bool:
    """libaom has_top_right geometry (rect-aware)."""
    bs = max(bw4, bh4)
    if bs > 16:  # > 64x64
        return False
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = False
                break
        else:
            break
        b <<= 1
    # rectangular partitions (libaom is_sec_rect rule): the non-final
    # vertical strip always has a TR; a non-first horizontal strip never
    if bw4 < bh4:  # vertical rectangle
        is_sec = ((mi_col + bw4) & (bh4 - 1)) == 0  # last strip
        if not is_sec:
            has_tr = True
    elif bw4 > bh4:  # horizontal rectangle
        is_sec = (mi_row & (bw4 - 1)) != 0
        if is_sec:
            has_tr = False
    return has_tr


class _Ctx:
    """Mutable accumulation state during the scans."""

    def __init__(self):
        self.mvs: list = []
        self.weights: list = []
        self.newmv_count = 0
        self.row_match = 0
        self.col_match = 0


def _add_candidate(st: _Ctx, grid: MvGrid, cr: int, cc: int,
                   ref_frame: int, weight: int, match_attr: str,
                   count_newmv: bool = True) -> None:
    cand_ref = int(grid.ref[cr, cc])
    if cand_ref <= INTRA_FRAME:  # intra or unset: not an inter candidate
        return
    if cand_ref != ref_frame:
        return
    mv = (int(grid.mv_r[cr, cc]), int(grid.mv_c[cr, cc]))
    setattr(st, match_attr, getattr(st, match_attr) + 1)
    if count_newmv and grid.newmv[cr, cc]:
        st.newmv_count += 1
    for i, m in enumerate(st.mvs):
        if m == mv:
            st.weights[i] += weight
            return
    if len(st.mvs) < MAX_REF_MV_STACK_SIZE:
        st.mvs.append(mv)
        st.weights.append(weight)


def _scan_row(st, grid, mi_row, mi_col, bw4, bh4, row_offset, ref_frame,
              max_row_offset, tile, count_newmv=True):
    """libaom scan_row_mbmi.  Returns processed_rows."""
    t_r0, t_r1, t_c0, t_c1 = tile
    end_mi = min(bw4, t_c1 - mi_col, 16)
    col_offset = 0
    if abs(row_offset) > 1:
        col_offset = 1
        if (mi_col & 1) and bw4 < 2:
            col_offset -= 1
    use_step_16 = bw4 >= 16
    processed_rows = 0
    row = mi_row + row_offset
    if not (t_r0 <= row < t_r1):
        return processed_rows
    i = 0
    while i < end_mi:
        cc = mi_col + col_offset + i
        if not (t_c0 <= cc < t_c1):
            break
        n4w = int(grid.n4_w[row, cc])
        if n4w <= 0:  # not yet coded (shouldn't happen in decode order)
            break
        length = min(bw4, n4w)
        if use_step_16:
            length = max(4, length)
        elif abs(row_offset) > 1:
            length = max(length, 2)
        weight = 2
        if bw4 >= 2 and bw4 <= n4w:
            inc = min(-max_row_offset + row_offset + 1,
                      int(grid.n4_h[row, cc]))
            weight = max(weight, inc)
            processed_rows = inc - row_offset - 1
        _add_candidate(st, grid, row, cc, ref_frame, length * weight,
                       "row_match", count_newmv)
        i += length
    return processed_rows


def _scan_col(st, grid, mi_row, mi_col, bw4, bh4, col_offset_arg, ref_frame,
              max_col_offset, tile, count_newmv=True):
    t_r0, t_r1, t_c0, t_c1 = tile
    end_mi = min(bh4, t_r1 - mi_row, 16)
    row_offset = 0
    if abs(col_offset_arg) > 1:
        row_offset = 1
        if (mi_row & 1) and bh4 < 2:
            row_offset -= 1
    use_step_16 = bh4 >= 16
    processed_cols = 0
    col = mi_col + col_offset_arg
    if not (t_c0 <= col < t_c1):
        return processed_cols
    i = 0
    while i < end_mi:
        cr = mi_row + row_offset + i
        if not (t_r0 <= cr < t_r1):
            break
        n4h = int(grid.n4_h[cr, col])
        if n4h <= 0:
            break
        length = min(bh4, n4h)
        if use_step_16:
            length = max(4, length)
        elif abs(col_offset_arg) > 1:
            length = max(length, 2)
        weight = 2
        if bh4 >= 2 and bh4 <= n4h:
            inc = min(-max_col_offset + col_offset_arg + 1,
                      int(grid.n4_w[cr, col]))
            weight = max(weight, inc)
            processed_cols = inc - col_offset_arg - 1
        _add_candidate(st, grid, cr, col, ref_frame, length * weight,
                       "col_match", count_newmv)
        i += length
    return processed_cols


def _scan_point(st, grid, mi_row, mi_col, dr, dc, ref_frame, tile,
                match_attr, count_newmv=True):
    t_r0, t_r1, t_c0, t_c1 = tile
    r, c = mi_row + dr, mi_col + dc
    if not (t_r0 <= r < t_r1 and t_c0 <= c < t_c1):
        return
    if grid.n4_w[r, c] <= 0:
        return
    _add_candidate(st, grid, r, c, ref_frame, 2 * 2, match_attr,
                   count_newmv)


def find_mv_stack(grid: MvGrid, mi_row: int, mi_col: int, bw4: int,
                  bh4: int, ref_frame: int, tile: tuple) -> MvStackResult:
    """tile = (row_start, row_end, col_start, col_end) in mi units."""
    t_r0, t_r1, t_c0, t_c1 = tile
    st = _Ctx()
    up_available = mi_row > t_r0
    left_available = mi_col > t_c0

    # sub-8x8 parity adjustments (spec find_mv_stack deltaRow/deltaCol)
    row_adj = 1 if (bh4 < 2 and (mi_row & 1)) else 0
    col_adj = 1 if (bw4 < 2 and (mi_col & 1)) else 0

    max_row_offset = 0
    if up_available:
        max_row_offset = -(MVREF_ROW_COLS << 1) + row_adj
        if bh4 < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = max(max_row_offset, t_r0 - mi_row)
    max_col_offset = 0
    if left_available:
        max_col_offset = -(MVREF_ROW_COLS << 1) + col_adj
        if bw4 < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = max(max_col_offset, t_c0 - mi_col)

    processed_rows = processed_cols = 0
    if abs(max_row_offset) >= 1:
        processed_rows = _scan_row(st, grid, mi_row, mi_col, bw4, bh4, -1,
                                   ref_frame, max_row_offset, tile)
    if abs(max_col_offset) >= 1:
        processed_cols = _scan_col(st, grid, mi_row, mi_col, bw4, bh4, -1,
                                   ref_frame, max_col_offset, tile)
    if _has_top_right(mi_row, mi_col, bw4, bh4):
        _scan_point(st, grid, mi_row, mi_col, -1, bw4, ref_frame, tile,
                    "row_match")

    close_matches = (st.row_match > 0) + (st.col_match > 0)
    nearest_count = len(st.mvs)
    for i in range(nearest_count):
        st.weights[i] += REF_CAT_LEVEL

    # (temporal MV scan: sequence disables ref_frame_mvs)
    zero_mv_ctx = 0

    # second outer area: top-left point + outer rings (NewMvCount is
    # frozen after the nearest scans — behaviorally confirmed vs libaom)
    _scan_point(st, grid, mi_row, mi_col, -1, -1, ref_frame, tile,
                "row_match", count_newmv=False)
    for idx in range(2, MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) and \
                abs(row_offset) > processed_rows:
            _scan_row(st, grid, mi_row, mi_col, bw4, bh4, row_offset,
                      ref_frame, max_row_offset, tile, count_newmv=False)
        if abs(col_offset) <= abs(max_col_offset) and \
                abs(col_offset) > processed_cols:
            _scan_col(st, grid, mi_row, mi_col, bw4, bh4, col_offset,
                      ref_frame, max_col_offset, tile, count_newmv=False)

    total_matches = (st.row_match > 0) + (st.col_match > 0)
    newmv_count = st.newmv_count
    refmv_count = len(st.mvs)

    # mode contexts (spec 7.10.2.x: CloseMatches / TotalMatches flags)
    if close_matches == 0:
        new_mv_ctx = min(total_matches, 1)
        ref_mv_ctx = total_matches
    elif close_matches == 1:
        new_mv_ctx = 3 - min(newmv_count, 1)
        ref_mv_ctx = 2 + total_matches
    else:
        new_mv_ctx = 5 - min(newmv_count, 1)
        ref_mv_ctx = 5

    # sort by weight (two bubble passes: nearest region, then rest)
    mvs, weights = st.mvs, st.weights
    ln = nearest_count
    while ln > 0:
        nr = 0
        for i in range(1, ln):
            if weights[i - 1] < weights[i]:
                weights[i - 1], weights[i] = weights[i], weights[i - 1]
                mvs[i - 1], mvs[i] = mvs[i], mvs[i - 1]
                nr = i
        ln = nr
    ln = refmv_count
    while ln > nearest_count:
        nr = nearest_count
        for i in range(nearest_count + 1, ln):
            if weights[i - 1] < weights[i]:
                weights[i - 1], weights[i] = weights[i], weights[i - 1]
                mvs[i - 1], mvs[i] = mvs[i], mvs[i - 1]
                nr = i
        ln = nr

    # single-ref extension when short (spec 7.10.2.12 extra search):
    # sweep the immediate row/col again accepting ANY inter ref
    # (sign-flip for opposite-direction refs; all our refs share
    # direction so the flip never triggers).  Both passes walk at most
    # num4x4 = min(w4, h4) units — NOT w4/h4 per pass (round-3 fix:
    # fuzz seed 30, a 32x16 NEARMV whose ALTREF donor sat at column
    # offset 6 was adopted by us but not by libaom).
    if refmv_count < MAX_MV_REF_CANDIDATES:
        def process_single(cr, cc):
            cand_ref = int(grid.ref[cr, cc])
            if cand_ref <= INTRA_FRAME:
                return
            mv = (int(grid.mv_r[cr, cc]), int(grid.mv_c[cr, cc]))
            for m in mvs:
                if m == mv:
                    return
            mvs.append(mv)
            weights.append(2)

        num4x4 = min(min(16, bw4), min(16, bh4))
        i = 0
        while abs(max_row_offset) >= 1 and i < num4x4 and \
                len(mvs) < MAX_MV_REF_CANDIDATES:
            cc = mi_col + i
            if not (t_c0 <= cc < t_c1) or grid.n4_w[mi_row - 1, cc] <= 0:
                break
            process_single(mi_row - 1, cc)
            i += int(grid.n4_w[mi_row - 1, cc])
        i = 0
        while abs(max_col_offset) >= 1 and i < num4x4 and \
                len(mvs) < MAX_MV_REF_CANDIDATES:
            cr = mi_row + i
            if not (t_r0 <= cr < t_r1) or grid.n4_h[cr, mi_col - 1] <= 0:
                break
            process_single(cr, mi_col - 1)
            i += int(grid.n4_h[cr, mi_col - 1])
        refmv_count = len(mvs)

    # clamp against the frame's edges (spec 7.10.2.14: MiRows / MiCols;
    # the original clamps against the tile's end, which differs below the
    # first of several tile rows)
    mi_rows, mi_cols = grid.ref.shape
    bw8, bh8 = bw4 * 4 * 8, bh4 * 4 * 8
    to_left = -(mi_col * 4) * 8
    to_right = ((mi_cols - bw4 - mi_col) * 4) * 8
    to_top = -(mi_row * 4) * 8
    to_bottom = ((mi_rows - bh4 - mi_row) * 4) * 8
    lo_c, hi_c = to_left - bw8 - MV_BORDER, to_right + bw8 + MV_BORDER
    lo_r, hi_r = to_top - bh8 - MV_BORDER, to_bottom + bh8 + MV_BORDER
    for i in range(refmv_count):
        r, c = mvs[i]
        mvs[i] = (min(max(r, lo_r), hi_r), min(max(c, lo_c), hi_c))

    return MvStackResult(mvs, weights, refmv_count, new_mv_ctx,
                         ref_mv_ctx, zero_mv_ctx)


# ---------------------------------------------------------------------------
# neighbour-derived contexts outside the stack
# ---------------------------------------------------------------------------

def intra_inter_ctx(grid: MvGrid, mi_row, mi_col, tile) -> int:
    t_r0, _, t_c0, _ = tile
    has_a = mi_row > t_r0
    has_l = mi_col > t_c0
    a_intra = has_a and int(grid.ref[mi_row - 1, mi_col]) == INTRA_FRAME
    l_intra = has_l and int(grid.ref[mi_row, mi_col - 1]) == INTRA_FRAME
    if has_a and has_l:
        return 3 if (a_intra and l_intra) else int(a_intra or l_intra)
    if has_a or has_l:
        return 2 * int(a_intra if has_a else l_intra)
    return 0


def _neighbor_ref_counts(grid: MvGrid, mi_row, mi_col, tile):
    counts = np.zeros(8, np.int32)
    t_r0, _, t_c0, _ = tile
    if mi_row > t_r0:
        r = int(grid.ref[mi_row - 1, mi_col])
        if r > INTRA_FRAME:
            counts[r] += 1
    if mi_col > t_c0:
        r = int(grid.ref[mi_row, mi_col - 1])
        if r > INTRA_FRAME:
            counts[r] += 1
    return counts


def _balance_ctx(c0: int, c1: int) -> int:
    if c0 == c1:
        return 1
    return 0 if c0 < c1 else 2


def single_ref_ctxs(grid: MvGrid, mi_row, mi_col, tile):
    """Contexts for single_ref_p1..p6 as (p1, p3, p4, p5, p2, p6)."""
    n = _neighbor_ref_counts(grid, mi_row, mi_col, tile)
    fwd = int(n[LAST_FRAME] + n[LAST2_FRAME] + n[LAST3_FRAME] +
              n[GOLDEN_FRAME])
    bwd = int(n[BWDREF_FRAME] + n[ALTREF2_FRAME] + n[ALTREF_FRAME])
    p1 = _balance_ctx(fwd, bwd)
    p3 = _balance_ctx(int(n[LAST_FRAME] + n[LAST2_FRAME]),
                      int(n[LAST3_FRAME] + n[GOLDEN_FRAME]))
    p4 = _balance_ctx(int(n[LAST_FRAME]), int(n[LAST2_FRAME]))
    p5 = _balance_ctx(int(n[LAST3_FRAME]), int(n[GOLDEN_FRAME]))
    p2 = _balance_ctx(int(n[BWDREF_FRAME] + n[ALTREF2_FRAME]),
                      int(n[ALTREF_FRAME]))
    p6 = _balance_ctx(int(n[BWDREF_FRAME]), int(n[ALTREF2_FRAME]))
    return p1, p3, p4, p5, p2, p6
