# Copied from av1tpu/specav1/tile.py (three departures, marked where they
# are: two for blocks that overhang the frame edge, and the MV stack's
# RefFrameSignBias; held to libaom by tests/test_torch_host.py and
# tests/test_torch_signbias.py).
"""AV1 tile decoding: partition tree, mode info, residual coefficients,
block reconstruction (spec §5.11, §7.11-7.13).

Intra (KEY/INTRA_ONLY) path first; inter added on top.  Mirrors the
spec's pseudocode so symbol-level desyncs can be localized against
libaom-produced streams.
"""

from __future__ import annotations

import numpy as np

from av1tpu_torch.specav1 import inter_recon, mvrefs, recon
from av1tpu_torch.specav1.msac import SymbolDecoder
from av1tpu_torch.specav1.headers import FrameHeader, SequenceHeader

# block sizes (w4, h4 in 4x4 units), spec BLOCK_SIZES_ALL order
BLOCK_SIZES = [
    (1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (4, 4), (4, 8),
    (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
    (32, 32), (1, 4), (4, 1), (2, 8), (8, 2), (4, 16), (16, 4),
]
BLOCK_4X4 = 0
BLOCK_8X8 = 3
BLOCK_16X16 = 6
BLOCK_32X32 = 9
BLOCK_64X64 = 12
BLOCK_128X128 = 15
_SQUARES = {1: BLOCK_4X4, 2: BLOCK_8X8, 4: BLOCK_16X16, 8: BLOCK_32X32,
            16: BLOCK_64X64, 32: BLOCK_128X128}

(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
 PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
 PARTITION_HORZ_4, PARTITION_VERT_4) = range(10)

# intra modes
(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
 D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
 PAETH_PRED) = range(13)
UV_CFL_PRED = 13
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)

# spec Mode_To_Txfm_Type (chroma intra tx-type derivation)
MODE_TO_TXFM = (recon.DCT_DCT, recon.ADST_DCT, recon.DCT_ADST,
                recon.DCT_DCT, recon.ADST_ADST, recon.ADST_DCT,
                recon.DCT_ADST, recon.DCT_ADST, recon.ADST_DCT,
                recon.ADST_ADST, recon.ADST_DCT, recon.DCT_ADST,
                recon.ADST_ADST, recon.DCT_DCT)

# inter Y modes (continuing the spec YMode numbering)
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16

# Size_Group (our BLOCK_SIZES index order)
# spec Size_Group (libaom size_group_lookup): groups {4x4,4x8,8x4}=0,
# {8x8,8x16,16x8}=1, {16x16,16x32,32x16}=2, {>=32x32}=3 — rect sizes
# share the group of the SMALLER square, not the larger (round-3 fix:
# the old table was shifted one group up for every rect size, desyncing
# intra-in-inter y_mode reads on foreign streams)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
              0, 0, 1, 1, 2, 2)

# tx sizes: (w, h)
TX_SIZES_ALL = [
    (4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
    (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16),
    (16, 4), (8, 32), (32, 8), (16, 64), (64, 16),
]
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = range(5)

# largest rect tx per block size (indices into TX_SIZES_ALL)
MAX_TX_SIZE_RECT = {
    BLOCK_4X4: 0, 1: 5, 2: 6, BLOCK_8X8: 1, 4: 7, 5: 8, BLOCK_16X16: 2,
    7: 9, 8: 10, BLOCK_32X32: 3, 10: 11, 11: 12, BLOCK_64X64: 4,
    13: 4, 14: 4, BLOCK_128X128: 4, 16: 13, 17: 14, 18: 15, 19: 16,
    20: 17, 21: 18,
}
# split (halving) tx size chain for depth recursion
SPLIT_TX_SIZE = {0: 0, 1: 0, 2: 1, 3: 2, 4: 3, 5: 0, 6: 0, 7: 1, 8: 1,
                 9: 2, 10: 2, 11: 3, 12: 3, 13: 5, 14: 6, 15: 7, 16: 8,
                 17: 9, 18: 10}

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
_TX_CLASS = {recon.V_DCT: TX_CLASS_VERT, recon.V_ADST: TX_CLASS_VERT,
             recon.V_FLIPADST: TX_CLASS_VERT, recon.H_DCT: TX_CLASS_HORIZ,
             recon.H_ADST: TX_CLASS_HORIZ,
             recon.H_FLIPADST: TX_CLASS_HORIZ}

_SKIP_CONTEXTS = np.array([
    [1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 6]], np.int32)

# ext tx sets: set index -> ordered tx types (intra)
EXT_TX_SET_DTT4_IDTX_1DDCT = (recon.IDTX, recon.DCT_DCT, recon.V_DCT,
                              recon.H_DCT, recon.ADST_ADST,
                              recon.ADST_DCT, recon.DCT_ADST)
EXT_TX_SET_DTT4_IDTX = (recon.IDTX, recon.DCT_DCT, recon.ADST_ADST,
                        recon.ADST_DCT, recon.DCT_ADST)
# inter sets
EXT_TX_SET_ALL16 = (recon.IDTX, recon.V_DCT, recon.H_DCT, recon.V_ADST,
                    recon.H_ADST, recon.V_FLIPADST, recon.H_FLIPADST,
                    recon.DCT_DCT, recon.ADST_DCT, recon.DCT_ADST,
                    recon.FLIPADST_DCT, recon.DCT_FLIPADST,
                    recon.ADST_ADST, recon.FLIPADST_FLIPADST,
                    recon.ADST_FLIPADST, recon.FLIPADST_ADST)
EXT_TX_SET_DTT9_IDTX_1DDCT = (recon.IDTX, recon.V_DCT, recon.H_DCT,
                              recon.DCT_DCT, recon.ADST_DCT,
                              recon.DCT_ADST, recon.FLIPADST_DCT,
                              recon.DCT_FLIPADST, recon.ADST_ADST,
                              recon.FLIPADST_FLIPADST,
                              recon.ADST_FLIPADST, recon.FLIPADST_ADST)
EXT_TX_SET_DCT_IDTX = (recon.IDTX, recon.DCT_DCT)


def tx_size_sqr_up(tx: int) -> int:
    w, h = TX_SIZES_ALL[tx]
    m = max(w, h)
    return {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[m]


def tx_size_sqr(tx: int) -> int:
    w, h = TX_SIZES_ALL[tx]
    m = min(w, h)
    return {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[m]


def txsize_entropy_ctx(tx: int) -> int:
    return min((tx_size_sqr(tx) + tx_size_sqr_up(tx) + 1) >> 1, 4)


def _zigzag(w: int, h: int) -> np.ndarray:
    """Default (diagonal) scan as array of (row, col).

    Square sizes alternate direction per anti-diagonal (classic
    zigzag); RECT sizes run every anti-diagonal in ONE direction —
    toward the longer axis (tall: top-right->bottom-left, wide:
    bottom-left->top-right).  Recovered from the libaom/libgav1
    .rodata tables (tools/extract_scans.py, round-3 fix: the
    alternating zigzag desyncs libaom on any rect-tx coefficient
    past the first diagonal)."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if w == h:
            # even diagonals run bottom-left -> top-right, odd reverse
            cells.sort(key=lambda rc: rc[0], reverse=(d % 2 == 0))
        elif w < h:
            cells.sort(key=lambda rc: rc[0])
        else:
            cells.sort(key=lambda rc: rc[0], reverse=True)
        out.extend(cells)
    return np.array(out, np.int32)


_scan_cache: dict = {}


def get_scan(tx: int, tx_type: int) -> np.ndarray:
    w, h = TX_SIZES_ALL[tx]
    w, h = min(w, 32), min(h, 32)
    cls = _TX_CLASS.get(tx_type, TX_CLASS_2D)
    key = (w, h, cls)
    if key not in _scan_cache:
        if cls == TX_CLASS_2D:
            sc = _zigzag(w, h)
        elif cls == TX_CLASS_VERT:
            # V_* (vertical 1-D transform) compacts energy into the top
            # rows: row-major scan (behaviorally pinned vs libaom)
            sc = np.array([(r, c) for r in range(h) for c in range(w)],
                          np.int32)
        else:
            # H_*: column-major scan
            sc = np.array([(r, c) for c in range(w) for r in range(h)],
                          np.int32)
        _scan_cache[key] = sc
    return _scan_cache[key]


class TileDecoder:
    def __init__(self, seq: SequenceHeader, hdr: FrameHeader, fc,
                 ref_planes: list | None = None):
        self.seq = seq
        self.hdr = hdr
        self.fc = fc
        self.bd = seq.bit_depth
        self.mi_cols = hdr.mi_cols
        self.mi_rows = hdr.mi_rows
        # inter state: full coded-size planes of the reference slots
        self.ref_planes = ref_planes
        self.mvgrid = mvrefs.MvGrid.create(hdr.mi_rows, hdr.mi_cols)
        self.blocks: list = []  # (mi_r, mi_c, bsize) in decode order
        self.sb4 = 32 if seq.use_128x128_superblock else 16
        # pad to SB size: blocks/txbs may extend beyond the visible
        # frame (spec codes them fully; output is cropped)
        aw = (hdr.frame_width + 63) & ~63
        ah = (hdr.frame_height + 63) & ~63
        dt = np.uint16 if self.bd > 8 else np.uint8
        cw, ch = aw >> seq.subsampling_x, ah >> seq.subsampling_y
        self.planes = [np.zeros((ah, aw), dt),
                       np.zeros((ch, cw), dt),
                       np.zeros((ch, cw), dt)]
        # mode-info grids
        mc, mr = self.mi_cols, self.mi_rows
        self.y_modes = np.zeros((mr, mc), np.int32)
        self.uv_modes = np.zeros((mr, mc), np.int32)
        self.skips = np.zeros((mr, mc), np.int32)
        self.decoded = np.zeros((mr, mc), bool)
        self.tx_w4 = np.zeros((mr, mc), np.int32)  # tx width in 4x4 units
        self.tx_h4 = np.zeros((mr, mc), np.int32)
        self.mi_size = np.zeros((mr, mc), np.int32)
        # per-mi interpolation filter (0 reg / 1 smooth / 2 sharp);
        # 3 = none (intra / not yet coded), the spec neighbor sentinel
        self.filters = np.full((mr, mc), 3, np.int8)
        # per-mi inter tx size (var-tx leaves), index into TX_SIZES_ALL
        self.inter_tx = np.zeros((mr, mc), np.int32)
        # TxTypes map (spec 5.11.47): luma tx type per 4x4 cell, read
        # back by chroma-inter compute_tx_type at the co-located cell
        self.txtypes = np.zeros((mr, mc), np.int8)
        # loop-restoration per-RU syntax (spec 5.11.57; filters applied
        # by the frame finish in decoder.py)
        if getattr(hdr.lr, "uses_lr", False):
            from av1tpu_torch.specav1 import lr as lr_mod
            self.lr_state = lr_mod.LrState(hdr, seq)
        else:
            self.lr_state = None

    # --- per-tile state -------------------------------------------------
    def decode_tile(self, data: bytes, mrs, mre, mcs, mce):
        self.r = SymbolDecoder(data)
        if self.lr_state is not None:
            self.lr_state.reset_refs()
        self.mrs, self.mre, self.mcs, self.mce = mrs, mre, mcs, mce
        n = self.mi_cols
        self.above_part = np.zeros(n, np.int32)
        self.above_levels = [np.zeros(n, np.int32) for _ in range(3)]
        self.above_dcsign = [np.zeros(n, np.int32) for _ in range(3)]
        self.above_txw = np.full(n, 64, np.int32)
        for r in range(mrs, mre, self.sb4):
            self.left_part = np.zeros(self.sb4, np.int32)
            self.left_levels = [np.zeros(self.sb4, np.int32)
                                for _ in range(3)]
            self.left_dcsign = [np.zeros(self.sb4, np.int32)
                                for _ in range(3)]
            self.left_txh = np.full(self.sb4, 64, np.int32)
            self.sb_row = r
            for c in range(mcs, mce, self.sb4):
                sb = BLOCK_128X128 if self.seq.use_128x128_superblock \
                    else BLOCK_64X64
                if self.lr_state is not None:
                    self.lr_state.read_lr(self, r, c, self.sb4, self.sb4)
                self.sb_col = c
                self._clear_block_decoded()
                self.decode_partition(r, c, sb)

    def _avail(self, r, c):
        return (self.mrs <= r < self.mre) and (self.mcs <= c < self.mce)

    # --- BlockDecoded (spec 7.12.2 / 5.11.37) -------------------------
    def _clear_block_decoded(self):
        """Reset the SB-local per-plane BlockDecoded maps (spec 7.12.2
        clear_block_decoded_flags): above row seeds decoded for
        x < sbWidth4 = (MiColEnd - MiCol) >> subX — the TILE end, so
        the above-right corner IS decoded unless this SB touches the
        tile's right edge; left column likewise for y < sbHeight4; the
        bottom-left corner is then forced 0 unconditionally (the SB
        below-left never precedes us in decode order).  Indexing:
        bd[plane][ly + 1][lx + 1] for SB-local plane-4x4 cell (ly, lx)
        with -1 borders."""
        self._bd = []
        for plane in range(3):
            ssx = self.seq.subsampling_x if plane else 0
            ssy = self.seq.subsampling_y if plane else 0
            w4 = self.sb4 >> ssx
            h4 = self.sb4 >> ssy
            sbw4 = (self.mce - self.sb_col) >> ssx
            sbh4 = (self.mre - self.sb_row) >> ssy
            bd = np.zeros((h4 + 2, w4 + 2), bool)
            bd[0, :min(sbw4, w4 + 1) + 1] = True  # y=-1, x<sbWidth4
            bd[:min(sbh4, h4 + 1) + 1, 0] = True  # x=-1, y<sbHeight4
            bd[h4 + 1, 0] = False      # bottom-left corner: always 0
            self._bd.append(bd)

    def _bd_mark(self, plane, x, y, tw, th):
        """Mark a decoded transform block's plane-4x4 cells."""
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        lx = (x >> 2) - ((self.sb_col >> ssx))
        ly = (y >> 2) - ((self.sb_row >> ssy))
        bd = self._bd[plane]
        bd[ly + 1:ly + 1 + (th >> 2), lx + 1:lx + 1 + (tw >> 2)] = True

    def _bd_have_tr_bl(self, plane, x, y, tw, th):
        """(haveAboveRight, haveBelowLeft) for a txb at plane px
        (x, y) — reads the SB-local BlockDecoded corners."""
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        lx = (x >> 2) - ((self.sb_col >> ssx))
        ly = (y >> 2) - ((self.sb_row >> ssy))
        bd = self._bd[plane]
        sx, sy = tw >> 2, th >> 2
        # spec: BlockDecoded[plane][ly - 1][lx + stepX] and
        # [ly + stepY][lx - 1]; txbs never extend past the SB, so the
        # +1-offset map covers every read
        tr = bool(bd[ly, lx + sx + 1])
        bl = bool(bd[ly + sy + 1, lx])
        return tr, bl

    # --- partition tree -------------------------------------------------
    def decode_partition(self, r, c, bsize):
        if r >= self.mre or c >= self.mce:
            return
        w4, h4 = BLOCK_SIZES[bsize]
        half = w4 >> 1
        has_rows = (r + half) < self.mre
        has_cols = (c + half) < self.mce
        bsl = w4.bit_length() - 1  # 8x8 -> 1 ... 128 -> 5
        if bsize == BLOCK_4X4:
            part = PARTITION_NONE
        else:
            above = int((self.above_part[c] >> bsl) & 1) \
                if self._avail(r - 1, c) else 0
            left = int((self.left_part[(r - self.sb_row) & (self.sb4 - 1)]
                        >> bsl) & 1) if self._avail(r, c - 1) else 0
            ctx = left * 2 + above
            cdf = self.fc.partition[bsl - 1][ctx]
            if has_rows and has_cols:
                nsyms = {1: 4, 2: 10, 3: 10, 4: 10, 5: 8}[bsl]
                part = self.r.read_adapt(cdf, nsyms)
            elif has_cols:
                split = self._read_split_bool(cdf, bsl, vertical=False)
                part = PARTITION_SPLIT if split else PARTITION_HORZ
            elif has_rows:
                split = self._read_split_bool(cdf, bsl, vertical=True)
                part = PARTITION_SPLIT if split else PARTITION_VERT
            else:
                part = PARTITION_SPLIT

        sub = _partition_subsize(part, bsize)
        split_sub = sub if bsize == BLOCK_4X4 \
            else _partition_subsize(PARTITION_SPLIT, bsize)
        if part == PARTITION_NONE:
            self.decode_block(r, c, sub)
        elif part == PARTITION_HORZ:
            self.decode_block(r, c, sub)
            if has_rows:
                self.decode_block(r + half, c, sub)
        elif part == PARTITION_VERT:
            self.decode_block(r, c, sub)
            if has_cols:
                self.decode_block(r, c + half, sub)
        elif part == PARTITION_SPLIT:
            self.decode_partition(r, c, split_sub)
            self.decode_partition(r, c + half, split_sub)
            self.decode_partition(r + half, c, split_sub)
            self.decode_partition(r + half, c + half, split_sub)
        elif part == PARTITION_HORZ_A:
            self.decode_block(r, c, split_sub)
            self.decode_block(r, c + half, split_sub)
            self.decode_block(r + half, c, sub)
        elif part == PARTITION_HORZ_B:
            self.decode_block(r, c, sub)
            self.decode_block(r + half, c, split_sub)
            self.decode_block(r + half, c + half, split_sub)
        elif part == PARTITION_VERT_A:
            self.decode_block(r, c, split_sub)
            self.decode_block(r + half, c, split_sub)
            self.decode_block(r, c + half, sub)
        elif part == PARTITION_VERT_B:
            self.decode_block(r, c, sub)
            self.decode_block(r, c + half, split_sub)
            self.decode_block(r + half, c + half, split_sub)
        elif part == PARTITION_HORZ_4:
            q = w4 >> 2
            for i in range(4):
                if r + i * q >= self.mre:
                    break
                self.decode_block(r + i * q, c, sub)
        elif part == PARTITION_VERT_4:
            q = w4 >> 2
            for i in range(4):
                if c + i * q >= self.mce:
                    break
                self.decode_block(r, c + i * q, sub)
        # write partition context for this node (SPLIT recursion writes
        # its own at the leaves).  AB partitions update the two halves
        # separately: the split-sized half records the split subsize,
        # the rect half the rect subsize (libaom
        # update_ext_partition_context; round-3 foreign-replay fix)
        if part != PARTITION_SPLIT:
            lr = (r - self.sb_row) & (self.sb4 - 1)

            def upd(rr, cc, size, rw4, rh4):
                ac, lc = _partition_context(size)
                self.above_part[cc:cc + rw4] = ac
                llr = (rr - self.sb_row) & (self.sb4 - 1)
                self.left_part[llr:llr + rh4] = lc

            if part == PARTITION_HORZ_A:
                upd(r, c, split_sub, w4, h4 >> 1)
                upd(r + (h4 >> 1), c, sub, w4, h4 >> 1)
            elif part == PARTITION_HORZ_B:
                upd(r, c, sub, w4, h4 >> 1)
                upd(r + (h4 >> 1), c, split_sub, w4, h4 >> 1)
            elif part == PARTITION_VERT_A:
                upd(r, c, split_sub, w4 >> 1, h4)
                upd(r, c + (w4 >> 1), sub, w4 >> 1, h4)
            elif part == PARTITION_VERT_B:
                upd(r, c, sub, w4 >> 1, h4)
                upd(r, c + (w4 >> 1), split_sub, w4 >> 1, h4)
            else:
                upd(r, c, sub, w4, h4)

    def _read_split_bool(self, cdf, bsl, vertical):
        """Edge partitions: derive P(split) by gathering the partition
        CDF probabilities of all partitions that split in the needed
        direction (spec partition gather)."""
        return self.r.decode_bool(split_bool_f(cdf, bsl, vertical))

    # --- block ----------------------------------------------------------
    def decode_block(self, r, c, bsize):
        if not self.hdr.frame_is_intra():
            return self._decode_block_interframe(r, c, bsize)
        return self._decode_block_intraframe(r, c, bsize)

    # --- inter-frame blocks (spec 5.11.15 inter_frame_mode_info) ---------
    def _decode_block_interframe(self, r, c, bsize):
        self.blocks.append((r, c, bsize))
        seq, hdr, fc = self.seq, self.hdr, self.fc
        w4, h4 = BLOCK_SIZES[bsize]
        bw4 = min(w4, self.mi_cols - c)
        bh4 = min(h4, self.mi_rows - r)
        avail_u = self._avail(r - 1, c)
        avail_l = self._avail(r, c - 1)
        tile = (self.mrs, self.mre, self.mcs, self.mce)
        # skip_mode absent (skip_mode_present = 0), then skip
        ctx = 0
        if avail_u:
            ctx += int(self.skips[r - 1, c])
        if avail_l:
            ctx += int(self.skips[r, c - 1])
        skip = self.r.read_adapt(fc.skip[ctx], 2)
        # is_inter
        ii_ctx = mvrefs.intra_inter_ctx(self.mvgrid, r, c, tile)
        is_inter = self.r.read_adapt(fc.intra_inter[ii_ctx], 2)
        y_mode = uv_mode = DC_PRED
        angle_y = angle_uv = 0
        mv = (0, 0)
        interp = 3
        ref_frame = 0  # INTRA_FRAME
        if is_inter:
            # read_ref_frames, single-reference tree (reference_select=0)
            ctxs = mvrefs.single_ref_ctxs(self.mvgrid, r, c, tile)
            b1 = self.r.read_adapt(fc.single_ref[ctxs[0]][0], 2)
            if b1:  # backward group
                b2 = self.r.read_adapt(fc.single_ref[ctxs[4]][1], 2)
                if b2:
                    ref_frame = mvrefs.ALTREF_FRAME
                else:
                    b6 = self.r.read_adapt(fc.single_ref[ctxs[5]][5], 2)
                    ref_frame = (mvrefs.ALTREF2_FRAME if b6
                                 else mvrefs.BWDREF_FRAME)
            else:
                b3 = self.r.read_adapt(fc.single_ref[ctxs[1]][2], 2)
                if b3:
                    b5 = self.r.read_adapt(fc.single_ref[ctxs[3]][4], 2)
                    ref_frame = (mvrefs.GOLDEN_FRAME if b5
                                 else mvrefs.LAST3_FRAME)
                else:
                    b4 = self.r.read_adapt(fc.single_ref[ctxs[2]][3], 2)
                    ref_frame = (mvrefs.LAST2_FRAME if b4
                                 else mvrefs.LAST_FRAME)
            stack = mvrefs.find_mv_stack(self.mvgrid, r, c, w4, h4,
                                         ref_frame, tile,
                                         hdr.ref_frame_sign_bias)
            # inter mode tree
            if self.r.read_adapt(fc.newmv[stack.new_mv_ctx], 2) == 0:
                y_mode = NEWMV
            elif self.r.read_adapt(fc.zeromv[stack.zero_mv_ctx], 2) == 0:
                y_mode = GLOBALMV
            elif self.r.read_adapt(fc.refmv[stack.ref_mv_ctx], 2) == 0:
                y_mode = NEARESTMV
            else:
                y_mode = NEARMV
            # read_drl_idx
            ref_mv_idx = 0
            if y_mode == NEWMV:
                for idx in range(2):
                    if stack.num_mv_found > idx + 1:
                        if self.r.read_adapt(
                                fc.drl[stack.drl_ctx(idx)], 2) == 0:
                            ref_mv_idx = idx
                            break
                        ref_mv_idx = idx + 1
            elif y_mode == NEARMV:
                ref_mv_idx = 1
                for idx in range(1, 3):
                    if stack.num_mv_found > idx + 1:
                        if self.r.read_adapt(
                                fc.drl[stack.drl_ctx(idx)], 2) == 0:
                            ref_mv_idx = idx
                            break
                        ref_mv_idx = idx + 1
            # assign_mv
            if y_mode == NEWMV:
                pred_mv = stack.ref_mv(ref_mv_idx)
                mv = self._read_mv(pred_mv)
            elif y_mode == NEARESTMV:
                mv = stack.ref_mv(0)
            elif y_mode == NEARMV:
                mv = stack.ref_mv(ref_mv_idx)
            else:  # GLOBALMV, identity
                mv = (0, 0)
            # read_motion_mode (our own streams set
            # is_motion_mode_switchable=0; needed to replay foreign
            # streams).  AllowWarpedMotion off in scope -> obmc bool.
            if hdr.is_motion_mode_switchable and \
                    min(BLOCK_SIZES[bsize]) * 4 >= 8 and \
                    self._has_overlappable(r, c, bsize, tile):
                mm = self.r.read_adapt(fc.obmc[bsize], 2)
                if mm:
                    raise NotImplementedError("OBMC prediction")
            # read_interpolation_filter (spec 5.11.27); dual_filter is
            # disabled at the sequence level in scope -> one symbol.
            # needs_interp_filter(): large GLOBALMV blocks follow the
            # global motion type (identity/non-translation -> EIGHTTAP,
            # no symbol) — skip_mode/warped are out of scope
            interp = hdr.interpolation_filter
            if interp == 4:  # SWITCHABLE
                if self.seq.enable_dual_filter:
                    raise NotImplementedError("dual filter")
                w4_, h4_ = BLOCK_SIZES[bsize]
                large = min(w4_, h4_) * 4 >= 8
                if large and y_mode == GLOBALMV:
                    interp = 0   # GmType IDENTITY (is_global 0): no bit
                else:
                    ictx = self._interp_filter_ctx(r, c, ref_frame, 0,
                                                   tile)
                    interp = self.r.read_adapt(
                        fc.switchable_interp[ictx], 3)
        else:
            # intra_block_mode_info
            y_mode = self.r.read_adapt(
                fc.if_y_mode[SIZE_GROUP[bsize]], 13)
            if bsize >= BLOCK_8X8 and V_PRED <= y_mode <= D67_PRED:
                angle_y = self.r.read_adapt(
                    fc.angle_delta[y_mode - V_PRED], 7) - 3
            if self._has_chroma(r, c, bsize):
                cfl_allowed = int(max(BLOCK_SIZES[bsize]) * 4 <= 32)
                uv_mode = self.r.read_adapt(
                    fc.uv_mode[cfl_allowed][y_mode],
                    14 if cfl_allowed else 13)
                if uv_mode == UV_CFL_PRED:
                    self._read_cfl_alphas()
                if bsize >= BLOCK_8X8 and V_PRED <= uv_mode <= D67_PRED:
                    angle_uv = self.r.read_adapt(
                        fc.angle_delta[uv_mode - V_PRED], 7) - 3
        # tx size (spec 5.11.15 block_tx_size): non-skip inter blocks
        # read the var-tx split tree; every other SELECT block reads
        # read_tx_size(allowSelect = !skip || !is_inter) — so INTRA
        # blocks code the depth even when skip (round-3 foreign fix)
        tx = MAX_TX_SIZE_RECT[bsize]
        var_tx = False
        if hdr.tx_mode == "TX_MODE_SELECT" and bsize > BLOCK_4X4:
            if is_inter and not skip:
                var_tx = True
            elif not is_inter:
                tx = self._read_tx_size(r, c, bsize, avail_u, avail_l)
        # store mode info
        self.y_modes[r:r + bh4, c:c + bw4] = y_mode if not is_inter \
            else DC_PRED
        self.uv_modes[r:r + bh4, c:c + bw4] = uv_mode
        self.skips[r:r + bh4, c:c + bw4] = skip
        self.mi_size[r:r + bh4, c:c + bw4] = bsize
        # the block's own dims, not the part inside the frame: the MV
        # scans weigh a neighbour by its coded size (the original stores
        # the clipped dims, and mispredicts beside a block that overhangs
        # the frame edge); the grid's slices end at the frame
        self.mvgrid.set_block(r, c, h4, w4, ref_frame, mv,
                              y_mode == NEWMV)
        self.filters[r:r + bh4, c:c + bw4] = interp if is_inter else 3
        tw, th = TX_SIZES_ALL[tx]
        self.tx_w4[r:r + bh4, c:c + bw4] = tw >> 2
        self.tx_h4[r:r + bh4, c:c + bw4] = th >> 2
        lr = (r - self.sb_row) & (self.sb4 - 1)
        if var_tx:
            # read_var_tx_size over the block in max-rect-tx units; the
            # recursion fills inter_tx and the above/left tx contexts
            sw4, sh4 = tw >> 2, th >> 2
            for i in range(0, h4, sh4):
                for j in range(0, w4, sw4):
                    self._read_var_tx_size(r + i, c + j, tx, 0, bsize)
        else:
            self.inter_tx[r:r + bh4, c:c + bw4] = tx
            # spec compute_tx_size ctx update: skip inter blocks record
            # the block dims, others the tx dims
            if skip and is_inter:
                self.above_txw[c:c + bw4] = w4 * 4
                self.left_txh[lr:lr + bh4] = h4 * 4
            else:
                self.above_txw[c:c + bw4] = tw
                self.left_txh[lr:lr + bh4] = th
        if is_inter:
            self._inter_residual(r, c, bsize, tx, ref_frame, mv, skip,
                                 interp, var_tx)
        else:
            self._predict_and_residual(r, c, bsize, tx, y_mode, uv_mode,
                                       angle_y, angle_uv, skip)
        self.decoded[r:r + bh4, c:c + bw4] = True

    def _interp_filter_ctx(self, r, c, ref_frame, dir_, tile):
        """spec: context for interp_filter[dir] from neighbours sharing
        the block's first reference frame."""
        t_r0, _, t_c0, _ = tile
        NONE = 3  # SWITCHABLE_FILTERS sentinel

        def ref_filter(nr, nc):
            if int(self.mvgrid.ref[nr, nc]) <= 0:
                return NONE
            nref = int(self.mvgrid.ref[nr, nc])
            if nref != ref_frame:
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

    def _read_var_tx_size(self, r, c, tx, depth, bsize):
        """spec 5.11.46 read_var_tx_size: recursive tx split tree."""
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        tw, th = TX_SIZES_ALL[tx]
        if tx == TX_4X4 or depth == 2:  # MAX_VARTX_DEPTH
            split = 0
        else:
            ctx = self._txfm_partition_ctx(r, c, bsize, tx)
            split = self.r.read_adapt(self.fc.txfm_partition[ctx], 2)
        lr = (r - self.sb_row) & (self.sb4 - 1)
        if split:
            sub = SPLIT_TX_SIZE[tx]
            sw, sh = TX_SIZES_ALL[sub]
            for i in range(0, th >> 2, sh >> 2):
                for j in range(0, tw >> 2, sw >> 2):
                    self._read_var_tx_size(r + i, c + j, sub, depth + 1,
                                           bsize)
        else:
            h4, w4 = th >> 2, tw >> 2
            self.inter_tx[r:r + h4, c:c + w4] = tx
            self.above_txw[c:c + w4] = tw
            self.left_txh[lr:lr + h4] = th

    def _txfm_partition_ctx(self, r, c, bsize, tx):
        tw, th = TX_SIZES_ALL[tx]
        above = int(int(self.above_txw[c]) < tw)
        left_r = (r - self.sb_row) & (self.sb4 - 1)
        left = int(int(self.left_txh[left_r]) < th)
        w4, h4 = BLOCK_SIZES[bsize]
        maxdim = min(max(w4, h4) * 4, 64)
        max_tx = {8: 1, 16: 2, 32: 3, 64: 4}[max(maxdim, 8)]
        tx_sqr_up = tx_size_sqr_up(tx)
        category = int(tx_sqr_up != max_tx and max_tx > 1) + \
            (4 - max_tx) * 2
        return category * 3 + above + left

    def _has_overlappable(self, r, c, bsize, tile):
        """spec has_overlappable_candidates: any inter block in the
        row above / column left of this block."""
        t_r0, _, t_c0, _ = tile
        w4, h4 = BLOCK_SIZES[bsize]
        if r > t_r0:
            for j in range(min(w4, self.mi_cols - c)):
                if self.mvgrid.ref[r - 1, c + j] > 0:
                    return True
        if c > t_c0:
            for i in range(min(h4, self.mi_rows - r)):
                if self.mvgrid.ref[r + i, c - 1] > 0:
                    return True
        return False

    def _read_mv(self, pred_mv):
        """spec 5.11.31/32 read_mv for our header config (no intrabc)."""
        fc, r = self.fc, self.r
        joint = r.read_adapt(fc.mv_joint, 4)
        dr = self._read_mv_component(0) if joint in (2, 3) else 0
        dc = self._read_mv_component(1) if joint in (1, 3) else 0
        return (pred_mv[0] + dr, pred_mv[1] + dc)

    def _read_mv_component(self, comp):
        fc, r = self.fc, self.r
        hdr = self.hdr
        m = fc.mv[comp]
        sign = r.read_adapt(m.sign, 2)
        mv_class = r.read_adapt(m.classes, 11)
        if mv_class == 0:
            int_bit = r.read_adapt(m.class0, 2)
            if hdr.force_integer_mv:
                fr = 3
            else:
                fr = r.read_adapt(m.class0_fp[int_bit], 4)
            hp = r.read_adapt(m.class0_hp, 2) \
                if hdr.allow_high_precision_mv else 1
            mag = ((int_bit << 3) | (fr << 1) | hp) + 1
        else:
            d = 0
            for i in range(mv_class):
                d |= r.read_adapt(m.bits[i], 2) << i
            mag = 2 << (mv_class + 2)
            if hdr.force_integer_mv:
                fr = 3
            else:
                fr = r.read_adapt(m.fp, 4)
            hp = r.read_adapt(m.hp, 2) \
                if hdr.allow_high_precision_mv else 1
            mag += ((d << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag

    def _inter_residual(self, r, c, bsize, tx, ref_frame, mv, skip,
                        interp=0, var_tx=False):
        seq, hdr = self.seq, self.hdr
        w4, h4 = BLOCK_SIZES[bsize]
        slot = hdr.ref_frame_idx[ref_frame - mvrefs.LAST_FRAME]
        refs = self.ref_planes[slot]
        tw, th = TX_SIZES_ALL[tx]
        x0, y0 = c * 4, r * 4
        bw, bh = w4 * 4, h4 * 4
        pred_y = inter_recon.predict_inter(refs[0], x0, y0, bw, bh, mv,
                                           0, 0, self.bd, interp)
        if var_tx:
            # spec transform_tree: recurse to the read_var_tx_size
            # leaves; 64-pixel chunking matches residual()'s loop
            for cy in range(0, bh, 64):
                for cx in range(0, bw, 64):
                    self._transform_tree(x0 + cx, y0 + cy,
                                         min(64, bw - cx),
                                         min(64, bh - cy), pred_y, x0, y0,
                                         skip, r, c)
        else:
            for ty in range(0, bh, th):
                for tx_x in range(0, bw, tw):
                    self._txb_inter(0, x0 + tx_x, y0 + ty, tx,
                                    pred_y[ty:ty + th, tx_x:tx_x + tw],
                                    skip, r, c)
        if self._has_chroma(r, c, bsize):
            ssx, ssy = seq.subsampling_x, seq.subsampling_y
            ctx_tx = _chroma_tx_size(bsize, ssx, ssy)
            ctw, cth = TX_SIZES_ALL[ctx_tx]
            cx0, cy0 = (c >> ssx) * 4, (r >> ssy) * 4
            cbw = max(w4 >> ssx, 1) * 4
            cbh = max(h4 >> ssy, 1) * 4
            # sub-8x8 chroma: the chroma block covers a pair/quad of
            # luma blocks; each part is predicted with its own luma
            # block's mv+ref (libaom build_inter_predictors_sub8x8),
            # unless any covering block is intra (is_sub8x8_inter)
            row_start = -1 if (h4 == 1 and ssy) else 0
            col_start = -1 if (w4 == 1 and ssx) else 0
            use_sub = (row_start or col_start) and all(
                int(self.mvgrid.ref[r + dr, c + dc]) > 0
                for dr in range(row_start, 1)
                for dc in range(col_start, 1))
            for plane in (1, 2):
                if use_sub:
                    pw, ph = (w4 * 4) >> ssx, (h4 * 4) >> ssy
                    pred = np.zeros((cbh, cbw), np.int64)
                    for j, dr in enumerate(range(row_start, 1)):
                        for i, dc in enumerate(range(col_start, 1)):
                            nref = int(self.mvgrid.ref[r + dr, c + dc])
                            nmv = (int(self.mvgrid.mv_r[r + dr, c + dc]),
                                   int(self.mvgrid.mv_c[r + dr, c + dc]))
                            nfil = int(self.filters[r + dr, c + dc])
                            if nfil >= 3:
                                nfil = 0
                            nslot = hdr.ref_frame_idx[
                                nref - mvrefs.LAST_FRAME]
                            nrefs = self.ref_planes[nslot]
                            pred[j * ph:(j + 1) * ph,
                                 i * pw:(i + 1) * pw] = \
                                inter_recon.predict_inter(
                                    nrefs[plane], cx0 + i * pw,
                                    cy0 + j * ph, pw, ph, nmv, ssx, ssy,
                                    self.bd, nfil)
                else:
                    pred = inter_recon.predict_inter(
                        refs[plane], cx0, cy0, cbw, cbh, mv, ssx, ssy,
                        self.bd, interp)
                for ty in range(0, cbh, cth):
                    for tx_x in range(0, cbw, ctw):
                        self._txb_inter(plane, cx0 + tx_x, cy0 + ty,
                                        ctx_tx,
                                        pred[ty:ty + cth, tx_x:tx_x + ctw],
                                        skip, r, c)

    def _transform_tree(self, sx, sy, w, h, pred_y, px0, py0, skip,
                        mi_r, mi_c):
        """spec 5.11.36 transform_tree (inter luma)."""
        row, col = sy >> 2, sx >> 2
        if row >= self.mi_rows or col >= self.mi_cols:
            return
        ltx = int(self.inter_tx[row, col])
        lw, lh = TX_SIZES_ALL[ltx]
        if w <= lw and h <= lh:
            tx = _find_tx_size(w, h)
            tw, th = TX_SIZES_ALL[tx]
            oy, ox = sy - py0, sx - px0
            self._txb_inter(0, sx, sy, tx,
                            pred_y[oy:oy + th, ox:ox + tw], skip,
                            mi_r, mi_c)
        elif w > h:
            self._transform_tree(sx, sy, w // 2, h, pred_y, px0, py0,
                                 skip, mi_r, mi_c)
            self._transform_tree(sx + w // 2, sy, w // 2, h, pred_y,
                                 px0, py0, skip, mi_r, mi_c)
        elif w < h:
            self._transform_tree(sx, sy, w, h // 2, pred_y, px0, py0,
                                 skip, mi_r, mi_c)
            self._transform_tree(sx, sy + h // 2, w, h // 2, pred_y,
                                 px0, py0, skip, mi_r, mi_c)
        else:
            hw, hh = w // 2, h // 2
            self._transform_tree(sx, sy, hw, hh, pred_y, px0, py0,
                                 skip, mi_r, mi_c)
            self._transform_tree(sx + hw, sy, hw, hh, pred_y, px0, py0,
                                 skip, mi_r, mi_c)
            self._transform_tree(sx, sy + hh, hw, hh, pred_y, px0, py0,
                                 skip, mi_r, mi_c)
            self._transform_tree(sx + hw, sy + hh, hw, hh, pred_y, px0,
                                 py0, skip, mi_r, mi_c)

    def _txb_inter(self, plane, x, y, tx, pred, skip, mi_r, mi_c):
        tw, th = TX_SIZES_ALL[tx]
        frame = self.planes[plane]
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        if x >= ((self.mi_cols * 4) >> ssx) or \
                y >= ((self.mi_rows * 4) >> ssy):
            return
        self._bd_mark(plane, x, y, tw, th)
        if skip:
            frame[y:y + th, x:x + tw] = np.clip(
                pred, 0, (1 << self.bd) - 1).astype(frame.dtype)
            self._set_ctx(plane, x, y, tw, th, 0, 0)
            return
        eob, levels, tx_type, culdc = self._coeffs(
            plane, x, y, tx, DC_PRED, is_inter=True, mi_rc=(mi_r, mi_c))
        if eob == 0:
            frame[y:y + th, x:x + tw] = np.clip(
                pred, 0, (1 << self.bd) - 1).astype(frame.dtype)
            return
        hdr = self.hdr
        if plane == 0:
            dcd, acd = hdr.delta_q_y_dc, 0
        elif plane == 1:
            dcd, acd = hdr.delta_q_u_dc, hdr.delta_q_u_ac
        else:
            dcd, acd = hdr.delta_q_v_dc, hdr.delta_q_v_ac
        dq = recon.dequant_coeffs(levels, hdr.base_q_idx, dcd, acd,
                                  self.bd, tw, th)
        out = recon.inv_txfm_add(dq, tx_type, pred, self.bd)
        frame[y:y + th, x:x + tw] = out.astype(frame.dtype)

    def _decode_block_intraframe(self, r, c, bsize):
        self.blocks.append((r, c, bsize))
        seq, hdr = self.seq, self.hdr
        w4, h4 = BLOCK_SIZES[bsize]
        bw4 = min(w4, self.mi_cols - c)
        bh4 = min(h4, self.mi_rows - r)
        avail_u = self._avail(r - 1, c)
        avail_l = self._avail(r, c - 1)
        # skip
        ctx = 0
        if avail_u:
            ctx += int(self.skips[r - 1, c])
        if avail_l:
            ctx += int(self.skips[r, c - 1])
        skip = self.r.read_adapt(self.fc.skip[ctx], 2)
        # intra y mode (keyframe): ctx from above/left modes
        above_mode = int(self.y_modes[r - 1, c]) if avail_u else DC_PRED
        left_mode = int(self.y_modes[r, c - 1]) if avail_l else DC_PRED
        actx = INTRA_MODE_CONTEXT[above_mode]
        lctx = INTRA_MODE_CONTEXT[left_mode]
        y_mode = self.r.read_adapt(self.fc.kf_y_mode[actx][lctx], 13)
        angle_y = 0
        if bsize >= BLOCK_8X8 and V_PRED <= y_mode <= D67_PRED:
            angle_y = self.r.read_adapt(
                self.fc.angle_delta[y_mode - V_PRED], 7) - 3
        # chroma
        has_chroma = self._has_chroma(r, c, bsize)
        uv_mode = DC_PRED
        angle_uv = 0
        if has_chroma:
            cfl_allowed = int(max(BLOCK_SIZES[bsize]) * 4 <= 32)
            nsyms = 14 if cfl_allowed else 13
            uv_mode = self.r.read_adapt(
                self.fc.uv_mode[cfl_allowed][y_mode], nsyms)
            if uv_mode == UV_CFL_PRED:
                self._read_cfl_alphas()
            if bsize >= BLOCK_8X8 and V_PRED <= uv_mode <= D67_PRED:
                angle_uv = self.r.read_adapt(
                    self.fc.angle_delta[uv_mode - V_PRED], 7) - 3
        # (palette, filter_intra: disabled by header/seq in scope)
        # tx size: intra blocks have allowSelect = !skip || !is_inter
        # = 1, so the depth is coded even for skip blocks (5.11.15)
        tx = MAX_TX_SIZE_RECT[bsize]
        if hdr.tx_mode == "TX_MODE_SELECT" and bsize > BLOCK_4X4:
            tx = self._read_tx_size(r, c, bsize, avail_u, avail_l)
        elif hdr.tx_mode == "ONLY_4X4":
            tx = TX_4X4
        # store mode info
        self.y_modes[r:r + bh4, c:c + bw4] = y_mode
        self.uv_modes[r:r + bh4, c:c + bw4] = uv_mode
        self.skips[r:r + bh4, c:c + bw4] = skip
        self.mi_size[r:r + bh4, c:c + bw4] = bsize
        tw, th = TX_SIZES_ALL[tx]
        self.tx_w4[r:r + bh4, c:c + bw4] = tw >> 2
        self.tx_h4[r:r + bh4, c:c + bw4] = th >> 2
        self.above_txw[c:c + bw4] = tw
        lr = (r - self.sb_row) & (self.sb4 - 1)
        self.left_txh[lr:lr + bh4] = th
        # reconstruct + residuals
        self._predict_and_residual(r, c, bsize, tx, y_mode, uv_mode,
                                   angle_y, angle_uv, skip)
        self.decoded[r:r + bh4, c:c + bw4] = True

    def _has_chroma(self, r, c, bsize):
        if self.seq.mono_chrome:
            return False
        w4, h4 = BLOCK_SIZES[bsize]
        ssx, ssy = self.seq.subsampling_x, self.seq.subsampling_y
        if w4 == 1 and ssx and (c & 1) == 0:
            return False
        if h4 == 1 and ssy and (r & 1) == 0:
            return False
        return True

    def _read_tx_size(self, r, c, bsize, avail_u, avail_l):
        max_rect = MAX_TX_SIZE_RECT[bsize]
        max_tx_w, max_tx_h = TX_SIZES_ALL[max_rect]
        w4, h4 = BLOCK_SIZES[bsize]
        depth_max = _max_tx_depth(bsize)
        if depth_max == 0:
            return max_rect
        # unavailable neighbours contribute nothing; inter neighbours
        # count their coding-block dims, intra their tx dims
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
        cat = _tx_size_cat(bsize)
        nsyms = min(depth_max, 2) + 1
        depth = self.r.read_adapt(self.fc.tx_size[cat][ctx], nsyms)
        tx = max_rect
        for _ in range(depth):
            tx = SPLIT_TX_SIZE[tx]
        return tx

    # --- residuals & recon ----------------------------------------------
    def _predict_and_residual(self, r, c, bsize, tx, y_mode, uv_mode,
                              angle_y, angle_uv, skip):
        seq = self.seq
        w4, h4 = BLOCK_SIZES[bsize]
        # iterate the FULL block; _txb skips tx blocks whose origin is
        # beyond the MI bounds (spec transform_block early-out); partial
        # txbs are coded at full size into the padded planes
        tw, th = TX_SIZES_ALL[tx]
        x0, y0 = c * 4, r * 4
        for ty in range(y0, y0 + h4 * 4, th):
            for tx_x in range(x0, x0 + w4 * 4, tw):
                self._txb(0, tx_x, ty, tx, y_mode, angle_y, skip,
                          r, c, bsize)
        if self._has_chroma(r, c, bsize):
            ssx, ssy = seq.subsampling_x, seq.subsampling_y
            cw4 = max(w4 >> ssx, 1)
            ch4 = max(h4 >> ssy, 1)
            ctx_tx = _chroma_tx_size(bsize, ssx, ssy)
            ctw, cth = TX_SIZES_ALL[ctx_tx]
            cx0, cy0 = (c >> ssx) * 4, (r >> ssy) * 4
            for plane in (1, 2):
                for ty in range(cy0, cy0 + ch4 * 4, cth):
                    for tx_x in range(cx0, cx0 + cw4 * 4, ctw):
                        self._txb(plane, tx_x, ty, ctx_tx, uv_mode,
                                  angle_uv, skip, r, c, bsize)

    def _read_cfl_alphas(self):
        """spec 5.11.45: joint sign + per-plane alpha magnitudes."""
        fc, r = self.fc, self.r
        js = r.read_adapt(fc.cfl_sign, 8)
        sign_u = (js + 1) // 3
        sign_v = (js + 1) % 3
        alpha_u = alpha_v = 0
        if sign_u != 0:
            ctx = js - 2
            alpha_u = r.read_adapt(fc.cfl_alpha[ctx], 16) + 1
            if sign_u == 1:
                alpha_u = -alpha_u
        if sign_v != 0:
            ctx = sign_v * 3 + sign_u - 3
            alpha_v = r.read_adapt(fc.cfl_alpha[ctx], 16) + 1
            if sign_v == 1:
                alpha_v = -alpha_v
        self._cfl_alphas = (alpha_u, alpha_v)

    def _cfl_pred(self, plane, x, y, tw, th, dc_pred):
        """spec 7.11.5: chroma-from-luma prediction for one chroma txb."""
        ssx, ssy = self.seq.subsampling_x, self.seq.subsampling_y
        alpha = self._cfl_alphas[plane - 1]
        luma = self.planes[0]
        lx, ly = x << ssx, y << ssy
        lw, lh = tw << ssx, th << ssy
        blk = luma[ly:ly + lh, lx:lx + lw].astype(np.int64)
        if ssx and ssy:
            sub = (blk[0::2, 0::2] + blk[0::2, 1::2] +
                   blk[1::2, 0::2] + blk[1::2, 1::2]) << 1
        elif ssx or ssy:
            a = blk[:, 0::2] + blk[:, 1::2] if ssx else \
                blk[0::2, :] + blk[1::2, :]
            sub = a << 2
        else:
            sub = blk << 3
        navg = (tw * th).bit_length() - 1
        avg = int(sub.sum()) >> navg
        ac = sub - avg
        # spec round2_signed(alpha * ac, 6)
        v = alpha * ac
        scaled = np.where(v >= 0, (v + 32) >> 6, -((-v + 32) >> 6))
        out = dc_pred.astype(np.int64) + scaled
        return np.clip(out, 0, (1 << self.bd) - 1)

    def _txb(self, plane, x, y, tx, mode, angle, skip, mi_r, mi_c, bsize):
        tw, th = TX_SIZES_ALL[tx]
        frame = self.planes[plane]
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        # spec transform_block: skip txbs whose origin lies beyond the
        # MI bounds
        if x >= ((self.mi_cols * 4) >> ssx) or \
                y >= ((self.mi_rows * 4) >> ssy):
            return
        # prediction; diagonal availability from the SB-local
        # BlockDecoded map (spec transform_block -> predict_intra)
        have_left = x > ((self.mcs * 4) >> ssx)
        have_above = y > ((self.mrs * 4) >> ssy)
        tr, bl = self._bd_have_tr_bl(plane, x, y, tw, th)
        n_tr = tw if tr else 0
        n_bl = th if bl else 0
        pred_mode = DC_PRED if (plane and mode == UV_CFL_PRED) else mode
        pred = recon.predict_intra(
            frame, x, y, tw, th, pred_mode, angle, self.bd,
            have_left, have_above, n_tr, n_bl,
            max_x=((self.mi_cols * 4) >> ssx) - 1,
            max_y=((self.mi_rows * 4) >> ssy) - 1,
            edge_filter=bool(self.seq.enable_intra_edge_filter),
            filt_type=self._filt_type(plane, mi_r, mi_c))
        if plane and mode == UV_CFL_PRED:
            pred = self._cfl_pred(plane, x, y, tw, th, pred)
        self._bd_mark(plane, x, y, tw, th)
        if skip:
            frame[y:y + th, x:x + tw] = np.clip(
                pred, 0, (1 << self.bd) - 1).astype(frame.dtype)
            self._set_ctx(plane, x, y, tw, th, 0, 0)
            return
        eob, levels, tx_type, culdc = self._coeffs(plane, x, y, tx, mode)
        if eob == 0:
            frame[y:y + th, x:x + tw] = np.clip(
                pred, 0, (1 << self.bd) - 1).astype(frame.dtype)
            return
        hdr = self.hdr
        if plane == 0:
            dcd, acd = hdr.delta_q_y_dc, 0
        elif plane == 1:
            dcd, acd = hdr.delta_q_u_dc, hdr.delta_q_u_ac
        else:
            dcd, acd = hdr.delta_q_v_dc, hdr.delta_q_v_ac
        dq = recon.dequant_coeffs(levels, hdr.base_q_idx, dcd, acd,
                                  self.bd, tw, th)
        out = recon.inv_txfm_add(dq, tx_type, pred, self.bd)
        frame[y:y + th, x:x + tw] = out.astype(frame.dtype)

    def _filt_type(self, plane, mi_r, mi_c):
        """spec get_filter_type: 1 when an above/left neighbour block
        uses a SMOOTH-family mode (per plane's mode grid)."""
        modes = self.y_modes if plane == 0 else self.uv_modes
        sm = (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED)
        above = self._avail(mi_r - 1, mi_c) and \
            int(modes[mi_r - 1, mi_c]) in sm
        left = self._avail(mi_r, mi_c - 1) and \
            int(modes[mi_r, mi_c - 1]) in sm
        return int(above or left)

    def _set_ctx(self, plane, x, y, tw, th, cul, dcsign):
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        c4 = (x >> 2) << ssx
        r4 = (y >> 2) << ssy
        w4 = (tw >> 2) << ssx
        h4 = (th >> 2) << ssy
        self.above_levels[plane][c4:c4 + w4] = min(cul, 63)
        self.above_dcsign[plane][c4:c4 + w4] = dcsign
        lr = r4 % self.sb4
        self.left_levels[plane][lr:lr + h4] = min(cul, 63)
        self.left_dcsign[plane][lr:lr + h4] = dcsign

    # --- coefficient parsing (spec 5.11.39) -------------------------------
    def _coeffs(self, plane, x, y, tx, intra_dir, is_inter=False,
                mi_rc=None):
        r = self.r
        fc = self.fc
        tw, th = TX_SIZES_ALL[tx]
        cw, ch = min(tw, 32), min(th, 32)
        ptype = int(plane > 0)
        txs_ctx = txsize_entropy_ctx(tx)
        ctx_skip = self._txb_skip_ctx(plane, x, y, tw, th)
        all_zero = r.read_adapt(fc.txb_skip[txs_ctx][ctx_skip], 2)
        if all_zero:
            self._set_ctx(plane, x, y, tw, th, 0, 0)
            if plane == 0:
                self.txtypes[y >> 2:(y + th) >> 2,
                             x >> 2:(x + tw) >> 2] = recon.DCT_DCT
            return 0, None, recon.DCT_DCT, 0
        # transform type (spec compute_tx_type)
        tx_type = recon.DCT_DCT
        if plane == 0:
            tx_type = self._read_tx_type(tx, intra_dir, is_inter)
            # TxTypes map: chroma-inter txbs re-read this at their
            # co-located luma cell (spec compute_tx_type)
            self.txtypes[y >> 2:(y + th) >> 2,
                         x >> 2:(x + tw) >> 2] = tx_type
        elif is_inter:
            # spec: TxTypes[Max(MiRow, blockY<<subY)][Max(MiCol,
            # blockX<<subX)] — the TOP-LEFT co-located luma cell, NOT
            # the last-parsed luma txb (var-tx blocks mix types;
            # round-3 foreign-replay fix)
            ssx = self.seq.subsampling_x
            ssy = self.seq.subsampling_y
            br, bc = mi_rc if mi_rc is not None else (0, 0)
            ly4 = min(max(br, (y >> 2) << ssy), self.mi_rows - 1)
            lx4 = min(max(bc, (x >> 2) << ssx), self.mi_cols - 1)
            tx_type = int(self.txtypes[ly4, lx4])
        else:
            # intra chroma: derived from the UV prediction mode
            tx_type = MODE_TO_TXFM[min(intra_dir, 13)]
        if plane:
            # clip to the chroma tx's set
            sq_up = tx_size_sqr_up(tx)
            if sq_up > (3 if is_inter else 2):
                tx_type = recon.DCT_DCT
            elif is_inter and sq_up == 3:
                if tx_type not in EXT_TX_SET_DCT_IDTX:
                    tx_type = recon.DCT_DCT
            elif not is_inter:
                sqr = tx_size_sqr(tx)
                tset = EXT_TX_SET_DTT4_IDTX if \
                    (self.hdr.reduced_tx_set or sqr == 2) else \
                    EXT_TX_SET_DTT4_IDTX_1DDCT
                if tx_type not in tset:
                    tx_type = recon.DCT_DCT
        tx_class = _TX_CLASS.get(tx_type, TX_CLASS_2D)
        # eob
        eob_size = cw * ch
        eob_cdf = fc.eob_pt[eob_size]
        eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
        nsyms = eob_cdf.shape[-1] - 1
        t = r.read_adapt(eob_cdf[ptype][eob_multi_ctx], nsyms) + 1
        if t < 2:
            eob = t
        else:
            eob = (1 << (t - 2)) + 1
            if t >= 3:
                extra = r.read_adapt(
                    fc.eob_extra[txs_ctx][ptype][t - 3], 2)
                eob += extra << (t - 3)
                for i in range(1, t - 2):
                    eob += r.read_literal(1) << (t - 3 - i)
        scan = get_scan(tx, tx_type)
        levels = np.zeros((ch + 4, cw + 4), np.int32)  # padded
        vals = np.zeros((ch, cw), np.int64)
        bwl = cw.bit_length() - 1
        # reverse scan: base (+br)
        for si in range(eob - 1, -1, -1):
            rr, cc = int(scan[si][0]), int(scan[si][1])
            if si == eob - 1:
                cec = _base_eob_ctx(si, cw, ch)
                lvl = r.read_adapt(
                    fc.coeff_base_eob[txs_ctx][ptype][cec], 3) + 1
            else:
                tw_full, th_full = TX_SIZES_ALL[tx]
                bctx = _base_ctx(levels, rr, cc, si, bwl, tx_class,
                                 tw_full, th_full)
                lvl = r.read_adapt(
                    fc.coeff_base[txs_ctx][ptype][bctx], 4)
            if lvl > 2:
                brctx = _br_ctx(levels, rr, cc, si, tx_class)
                for _ in range(4):
                    k = r.read_adapt(fc.coeff_br[
                        min(txs_ctx, 3)][ptype][brctx], 4)
                    lvl += k
                    if k < 3:
                        break
            levels[rr, cc] = min(lvl, 127)
            vals[rr, cc] = lvl
        # forward scan: signs + golomb
        culdc = 0
        cul = 0
        for si in range(eob):
            rr, cc = int(scan[si][0]), int(scan[si][1])
            lvl = int(vals[rr, cc])
            if lvl == 0:
                continue
            if si == 0:
                sctx = self._dc_sign_ctx(plane, x, y, tw, th)
                sign = r.read_adapt(fc.dc_sign[ptype][sctx], 2)
            else:
                sign = r.read_literal(1)
            if lvl > 14:
                lvl += _read_golomb(r)
            vals[rr, cc] = -lvl if sign else lvl
            cul += lvl
            if si == 0:
                culdc = -1 if sign else 1
        cul = min(cul, 63)
        self._set_ctx(plane, x, y, tw, th, cul, culdc)
        # place coded 32x32 region into full tx block
        full = np.zeros((th, tw), np.int64)
        full[:ch, :cw] = vals
        return eob, full, tx_type, culdc

    def _read_tx_type(self, tx, intra_dir, is_inter=False):
        sq_up = tx_size_sqr_up(tx)
        if self.hdr.base_q_idx == 0 or sq_up > (3 if is_inter else 2):
            return recon.DCT_DCT
        if is_inter:
            sqr = tx_size_sqr(tx)
            if self.hdr.reduced_tx_set or sq_up == 3:
                txset, set_idx = EXT_TX_SET_DCT_IDTX, 3
            elif sqr == 2:
                txset, set_idx = EXT_TX_SET_DTT9_IDTX_1DDCT, 2
            else:
                txset, set_idx = EXT_TX_SET_ALL16, 1
            sym = self.r.read_adapt(self.fc.inter_ext_tx[set_idx][sqr],
                                    len(txset))
            return txset[sym]
        sqr = tx_size_sqr(tx)
        if self.hdr.reduced_tx_set or sqr == 2:
            txset = EXT_TX_SET_DTT4_IDTX
            set_idx = 2
        else:
            txset = EXT_TX_SET_DTT4_IDTX_1DDCT
            set_idx = 1
        sym = self.r.read_adapt(
            self.fc.intra_ext_tx[set_idx][sqr][intra_dir], len(txset))
        return txset[sym]

    def _ctx_span(self, c4, r4, w4, h4):
        """The part of a transform block's above / left context span that
        lies inside the frame (spec 8.3.2: the context sums skip units at
        or beyond MiCols / MiRows, which a block overhanging the frame
        edge has).  Not in the original, which reads the whole span and
        so loses the stream in such a block; the encoder is exact in
        libaom there."""
        return (min(w4, max(self.mi_cols - c4, 0)),
                min(h4, max(self.mi_rows - r4, 0)))

    def _txb_skip_ctx(self, plane, x, y, tw, th):
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        c4 = (x >> 2) << ssx
        r4 = (y >> 2) << ssy
        w4 = (tw >> 2) << ssx
        h4 = (th >> 2) << ssy
        w4, h4 = self._ctx_span(c4, r4, w4, h4)
        a = self.above_levels[plane][c4:c4 + w4]
        lr = r4 % self.sb4
        ll = self.left_levels[plane][lr:lr + h4]
        if plane == 0:
            bsize = int(self.mi_size[min(y >> 2, self.mi_rows - 1),
                                     min(x >> 2, self.mi_cols - 1)])
            bw4, bh4 = BLOCK_SIZES[bsize]
            if bw4 * 4 == tw and bh4 * 4 == th:
                return 0
            top = int(min(a.max(initial=0), 4))
            left = int(min(ll.max(initial=0), 4))
            mx = min(top | left, 4)
            mn = min(min(top, left), 4)
            return int(_SKIP_CONTEXTS[mn][mx])
        above_nz = int((a != 0).any())
        left_nz = int((ll != 0).any())
        bsize = int(self.mi_size[min((y << ssy) >> 2, self.mi_rows - 1),
                                 min((x << ssx) >> 2, self.mi_cols - 1)])
        bw4, bh4 = BLOCK_SIZES[bsize]
        cbw = max(bw4 >> ssx, 1) * 4
        cbh = max(bh4 >> ssy, 1) * 4
        offset = 7 if (cbw * cbh <= tw * th) else 10
        return offset + above_nz + left_nz

    def _dc_sign_ctx(self, plane, x, y, tw, th):
        ssx = self.seq.subsampling_x if plane else 0
        ssy = self.seq.subsampling_y if plane else 0
        c4 = (x >> 2) << ssx
        r4 = (y >> 2) << ssy
        w4 = (tw >> 2) << ssx
        h4 = (th >> 2) << ssy
        w4, h4 = self._ctx_span(c4, r4, w4, h4)
        s = int(self.above_dcsign[plane][c4:c4 + w4].sum())
        lr = r4 % self.sb4
        s += int(self.left_dcsign[plane][lr:lr + h4].sum())
        if s < 0:
            return 1
        if s > 0:
            return 2
        return 0


def _read_golomb(r) -> int:
    length = 0
    while True:
        bit = r.read_literal(1)
        length += 1
        if bit or length > 20:
            break
    x = 1
    for _ in range(length - 1):
        x = (x << 1) | r.read_literal(1)
    return x - 1


def _base_eob_ctx(si, cw, ch):
    if si == 0:
        return 0
    n = cw * ch
    if si <= n // 8:
        return 1
    if si <= n // 4:
        return 2
    return 3


def _base_ctx(levels, rr, cc, si, bwl, tx_class, cw=0, ch=0):
    if tx_class == TX_CLASS_2D:
        mag = (min(int(levels[rr, cc + 1]), 3) +
               min(int(levels[rr + 1, cc]), 3) +
               min(int(levels[rr + 1, cc + 1]), 3) +
               min(int(levels[rr, cc + 2]), 3) +
               min(int(levels[rr + 2, cc]), 3))
        ctx = min((mag + 1) >> 1, 4)
        # position-band offsets (libaom av1_nz_map_ctx_offset
        # generator): DC -> 0; TALL txs use offset 11 for the top two
        # rows, WIDE txs offset 16 for the left two columns (round-3
        # rect fix); otherwise r+c bands 1 / 6 / 21
        if (rr | cc) == 0:
            return 0
        if cw < ch and rr < 2:
            return ctx + 11
        if cw > ch and cc < 2:
            return ctx + 16
        if rr + cc < 2:
            return ctx + 1
        if rr + cc < 4:
            return ctx + 6
        return ctx + 21
    # 1-D classes share the right+below pair, then extend along the
    # transform axis (libaom get_nz_mag)
    mag = (min(int(levels[rr + 1, cc]), 3) +
           min(int(levels[rr, cc + 1]), 3))
    if tx_class == TX_CLASS_HORIZ:
        mag += (min(int(levels[rr, cc + 2]), 3) +
                min(int(levels[rr, cc + 3]), 3) +
                min(int(levels[rr, cc + 4]), 3))
        pos = cc
    else:
        mag += (min(int(levels[rr + 2, cc]), 3) +
                min(int(levels[rr + 3, cc]), 3) +
                min(int(levels[rr + 4, cc]), 3))
        pos = rr
    ctx = min((mag + 1) >> 1, 4)
    # 1D bands: pos 0 -> +26, pos 1 -> +31, pos >= 2 -> +36
    if pos == 0:
        return ctx + 26
    if pos == 1:
        return ctx + 31
    return ctx + 36


def _br_ctx(levels, rr, cc, si, tx_class):
    if tx_class == TX_CLASS_2D:
        mag = (min(int(levels[rr, cc + 1]), 15) +
               min(int(levels[rr + 1, cc]), 15) +
               min(int(levels[rr + 1, cc + 1]), 15))
    elif tx_class == TX_CLASS_HORIZ:
        mag = (min(int(levels[rr, cc + 1]), 15) +
               min(int(levels[rr + 1, cc]), 15) +
               min(int(levels[rr, cc + 2]), 15))
    else:
        mag = (min(int(levels[rr, cc + 1]), 15) +
               min(int(levels[rr + 1, cc]), 15) +
               min(int(levels[rr + 2, cc]), 15))
    mag = min((mag + 1) >> 1, 6)
    if (rr | cc) == 0:
        return mag
    if tx_class == TX_CLASS_2D:
        if rr < 2 and cc < 2:
            return mag + 7
        return mag + 14
    pos = cc if tx_class == TX_CLASS_HORIZ else rr
    if pos == 0:
        return mag + 7
    return mag + 14


def _partition_subsize(part, bsize):
    w4, h4 = BLOCK_SIZES[bsize]
    if part == PARTITION_NONE:
        return bsize
    if part == PARTITION_SPLIT:
        return _SQUARES[w4 >> 1]
    if part in (PARTITION_HORZ, PARTITION_HORZ_A, PARTITION_HORZ_B):
        return _find_bsize(w4, h4 >> 1)
    if part in (PARTITION_VERT, PARTITION_VERT_A, PARTITION_VERT_B):
        return _find_bsize(w4 >> 1, h4)
    if part == PARTITION_HORZ_4:
        return _find_bsize(w4, h4 >> 2)
    return _find_bsize(w4 >> 2, h4)


def _find_tx_size(w, h):
    for t, (tw, th) in enumerate(TX_SIZES_ALL):
        if tw == w and th == h:
            return t
    raise ValueError((w, h))


def _find_bsize(w4, h4):
    for i, (w, h) in enumerate(BLOCK_SIZES):
        if w == w4 and h == h4:
            return i
    raise ValueError((w4, h4))


def _partition_context(bsize):
    """(above, left) partition-context bytes for a just-decoded block:
    bit bsl is set iff the block dimension is STRICTLY smaller than the
    partition size being read (empirically pinned against libaom:
    an equal-size neighbour gives ctx 0).  width 4px -> 62, 8 -> 60,
    16 -> 56, 32 -> 48, 64 -> 32, 128 -> 0."""
    w4, h4 = BLOCK_SIZES[bsize]
    above = {1: 62, 2: 60, 4: 56, 8: 48, 16: 32, 32: 0}[w4]
    left = {1: 62, 2: 60, 4: 56, 8: 48, 16: 32, 32: 0}[h4]
    return above, left


def _max_tx_depth(bsize):
    w4, h4 = BLOCK_SIZES[bsize]
    mx = max(w4, h4) * 4
    return {4: 0, 8: 1, 16: 2, 32: 3, 64: 4, 128: 4}[mx]


def _tx_size_cat(bsize):
    return min(_max_tx_depth(bsize) - 1, 3)


def _chroma_tx_size(bsize, ssx, ssy):
    w4, h4 = BLOCK_SIZES[bsize]
    cw = max((w4 * 4) >> ssx, 4)
    ch = max((h4 * 4) >> ssy, 4)
    cw, ch = min(cw, 32), min(ch, 32)
    for i, (w, h) in enumerate(TX_SIZES_ALL):
        if w == cw and h == ch:
            return i
    raise ValueError((cw, ch))


SPLIT_MEMBERS_HORZ = [PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
                      PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_VERT_4]
SPLIT_MEMBERS_VERT = [PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A,
                      PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_HORZ_4]


def split_bool_f(cdf, bsl: int, vertical: bool) -> int:
    """f15 (the icdf of the not-split symbol, i.e. the SPLIT mass) for
    the edge-partition bool (libaom partition_gather_*_alongside).

    vertical=False: bottom edge (HORZ vs SPLIT); vertical=True: right
    edge (VERT vs SPLIT).  Bit 1 = SPLIT.  Behaviorally pinned against
    libaom keyframes at edge geometries (64x32/128x96/192x120)."""
    nsyms = {1: 4, 2: 10, 3: 10, 4: 10, 5: 8}[bsl]
    probs = _icdf_to_probs(cdf, nsyms)
    members = SPLIT_MEMBERS_VERT if vertical else SPLIT_MEMBERS_HORZ
    psplit = sum(probs[m] for m in members if m < nsyms)
    return min(max(psplit, 1), 32767)


def _icdf_to_probs(cdf, nsyms):
    probs = []
    prev = 32768
    for i in range(nsyms):
        cur = int(cdf[i])
        probs.append(prev - cur)
        prev = cur
    return probs
