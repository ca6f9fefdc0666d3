// Copied from av1tpu/encoder/entropy/native/spec_tile.cc (without the CDF
// read-back, which the port does not use).  Departure from the original's
// bytes: the extra MV search negates a candidate whose reference's sign
// bias differs from the block's (spec 7.10.2.12; stw_set_sign_bias), and
// the inter walk counts its blocks and negations (stw_counts).
// Spec-AV1 tile writer: the sequential entropy hot loop, in C++.
//
// Port of av1tpu/specav1/writer.py (TileWriter) for the fixed-32x32
// intra grid the TPU keyframe encoder emits.  Per-symbol Python call
// overhead dominates at video rates (~seconds/frame at 1080p); this
// walks the whole tile in one ctypes call.  Byte-identical output to
// the Python TileWriter is enforced by tests/test_spec_native.py, and
// the streams are decode-verified by system libaom.
//
// Replaces the entropy engine inside the reference's exec'd ffmpeg
// binary (SURVEY.md §2 #16); syntax follows the AV1 spec §5.11.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "ec.h"

namespace {

// ---- spec tables ---------------------------------------------------------

// BLOCK_SIZES (w4, h4) — tile.py:18
struct BlkDim { int w4, h4; };
const BlkDim kBlockSizes[22] = {
    {1, 1},  {1, 2},  {2, 1},  {2, 2},  {2, 4},  {4, 2},  {4, 4},  {4, 8},
    {8, 4},  {8, 8},  {8, 16}, {16, 8}, {16, 16}, {16, 32}, {32, 16},
    {32, 32}, {1, 4},  {4, 1},  {2, 8},  {8, 2},  {4, 16}, {16, 4}};
constexpr int BLOCK_8X8 = 3;
constexpr int BLOCK_16X16 = 6;
constexpr int BLOCK_32X32 = 9;
constexpr int BLOCK_64X64 = 12;

constexpr int PARTITION_NONE = 0;
constexpr int PARTITION_SPLIT = 3;

// TX_SIZES_ALL (w, h) — tile.py:44
struct TxDim { int w, h; };
const TxDim kTxSizes[19] = {
    {4, 4},  {8, 8},  {16, 16}, {32, 32}, {64, 64}, {4, 8},  {8, 4},
    {8, 16}, {16, 8}, {16, 32}, {32, 16}, {32, 64}, {64, 32}, {4, 16},
    {16, 4}, {8, 32}, {32, 8},  {16, 64}, {64, 16}};
constexpr int TX_8X8 = 1;
constexpr int TX_16X16 = 2;
constexpr int TX_32X32 = 3;

const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
constexpr int V_PRED = 1;
constexpr int D67_PRED = 8;

// partition-context bytes per just-coded block dim — tile.py:759
inline int part_ctx_byte(int n4) {
  switch (n4) {
    case 1: return 62;
    case 2: return 60;
    case 4: return 56;
    case 8: return 48;
    case 16: return 32;
    default: return 0;  // 32 (128px)
  }
}

const int kSkipContexts[5][5] = {{1, 2, 2, 2, 3},
                                 {1, 4, 4, 4, 5},
                                 {1, 4, 4, 4, 5},
                                 {1, 4, 4, 4, 5},
                                 {1, 4, 4, 4, 6}};

inline int log2i(int v) {
  int r = 0;
  while ((1 << (r + 1)) <= v) ++r;
  return r;
}

inline int tx_size_sqr(int tx) {
  int m = kTxSizes[tx].w < kTxSizes[tx].h ? kTxSizes[tx].w : kTxSizes[tx].h;
  return log2i(m) - 2;
}
inline int tx_size_sqr_up(int tx) {
  int m = kTxSizes[tx].w > kTxSizes[tx].h ? kTxSizes[tx].w : kTxSizes[tx].h;
  return log2i(m) - 2;
}
inline int txsize_entropy_ctx(int tx) {
  int v = (tx_size_sqr(tx) + tx_size_sqr_up(tx) + 1) >> 1;
  return v < 4 ? v : 4;
}

inline int imin(int a, int b) { return a < b ? a : b; }
inline int imax(int a, int b) { return a > b ? a : b; }

// default (diagonal, alternating) zigzag scan — tile.py:_zigzag
void build_zigzag(int w, int h, std::vector<int> *rows,
                  std::vector<int> *cols) {
  rows->clear();
  cols->clear();
  for (int d = 0; d < w + h - 1; ++d) {
    if (d % 2 == 0) {  // bottom-left -> top-right
      for (int r = imin(d, h - 1); r >= 0; --r) {
        int c = d - r;
        if (c >= 0 && c < w) {
          rows->push_back(r);
          cols->push_back(c);
        }
      }
    } else {
      for (int r = 0; r <= imin(d, h - 1); ++r) {
        int c = d - r;
        if (c >= 0 && c < w) {
          rows->push_back(r);
          cols->push_back(c);
        }
      }
    }
  }
}

// eob_pt group index (1-based) — writer.py:_eob_pt
inline int eob_pt_group(int eob) {
  if (eob <= 2) return eob;
  int t = 0, v = eob - 1;
  while (v) {
    ++t;
    v >>= 1;
  }
  return t + 1;
}

// coefficient context helpers — tile.py:_base_eob_ctx/_base_ctx/_br_ctx
inline int base_eob_ctx(int si, int cw, int ch) {
  if (si == 0) return 0;
  int n = cw * ch;
  if (si <= n / 8) return 1;
  if (si <= n / 4) return 2;
  return 3;
}

// levels buffer: (ch+4) x (cw+4), row stride cw+4 (padded below/right)
inline int base_ctx_2d(const uint8_t *lv, int stride, int rr, int cc) {
  int mag = imin(lv[rr * stride + cc + 1], 3) +
            imin(lv[(rr + 1) * stride + cc], 3) +
            imin(lv[(rr + 1) * stride + cc + 1], 3) +
            imin(lv[rr * stride + cc + 2], 3) +
            imin(lv[(rr + 2) * stride + cc], 3);
  int ctx = imin((mag + 1) >> 1, 4);
  if ((rr | cc) == 0) return 0;
  if (rr + cc < 2) return ctx + 1;
  if (rr + cc < 4) return ctx + 6;
  return ctx + 21;
}

inline int br_ctx_2d(const uint8_t *lv, int stride, int rr, int cc) {
  int mag = imin(lv[rr * stride + cc + 1], 15) +
            imin(lv[(rr + 1) * stride + cc], 15) +
            imin(lv[(rr + 1) * stride + cc + 1], 15);
  mag = imin((mag + 1) >> 1, 6);
  if ((rr | cc) == 0) return mag;
  if (rr < 2 && cc < 2) return mag + 7;
  return mag + 14;
}

// ---- CDF table registry ---------------------------------------------------
// Shapes mirror FrameContext (cdfs.py) after the q-quartile slice; the
// trailing slot of each row is the adaptation counter (ICDF+counter).

enum TableId {
  TBL_PARTITION = 0,    // [5][4][11]
  TBL_SKIP = 1,         // [3][3]
  TBL_KF_Y_MODE = 2,    // [5][5][14]
  TBL_ANGLE_DELTA = 3,  // [8][8]
  TBL_UV_MODE = 4,      // [2][13][15]
  TBL_TXB_SKIP = 5,     // [5][13][3]
  TBL_EOB_PT_16 = 6,    // [2][2][6]
  TBL_EOB_PT_32 = 7,    // [2][2][7]
  TBL_EOB_PT_64 = 8,    // [2][2][8]
  TBL_EOB_PT_128 = 9,   // [2][2][9]
  TBL_EOB_PT_256 = 10,  // [2][2][10]
  TBL_EOB_PT_512 = 11,  // [2][2][11]
  TBL_EOB_PT_1024 = 12, // [2][2][12]
  TBL_EOB_EXTRA = 13,   // [5][2][9][3]
  TBL_COEFF_BASE_EOB = 14,  // [5][2][4][4]
  TBL_COEFF_BASE = 15,      // [5][2][42][5]
  TBL_COEFF_BR = 16,        // [5][2][21][5]
  TBL_DC_SIGN = 17,         // [2][3][3]
  TBL_INTRA_EXT_TX = 18,    // [3][4][13][17]
  // inter-frame tables
  TBL_IF_Y_MODE = 19,       // [4][14]
  TBL_INTRA_INTER = 20,     // [4][3]
  TBL_SINGLE_REF = 21,      // [3][6][3]
  TBL_NEWMV = 22,           // [6][3]
  TBL_ZEROMV = 23,          // [2][3]
  TBL_REFMV = 24,           // [6][3]
  TBL_DRL = 25,             // [3][3]
  TBL_MV_JOINT = 26,        // [5]
  TBL_MV_SIGN = 27,         // [2][3]
  TBL_MV_CLASSES = 28,      // [2][12]
  TBL_MV_CLASS0 = 29,       // [2][3]
  TBL_MV_BITS = 30,         // [2][10][3]
  TBL_MV_CLASS0_FP = 31,    // [2][2][5]
  TBL_MV_FP = 32,           // [2][5]
  TBL_INTER_EXT_TX = 33,    // [4][4][17]
  TBL_RESTORE_WIENER = 34,  // [1][3]
  TBL_COUNT = 35,
};

const int kTableSize[TBL_COUNT] = {
    5 * 4 * 11,       3 * 3,           5 * 5 * 14,  8 * 8,
    2 * 13 * 15,      5 * 13 * 3,      2 * 2 * 6,   2 * 2 * 7,
    2 * 2 * 8,        2 * 2 * 9,       2 * 2 * 10,  2 * 2 * 11,
    2 * 2 * 12,       5 * 2 * 9 * 3,   5 * 2 * 4 * 4, 5 * 2 * 42 * 5,
    5 * 2 * 21 * 5,   2 * 3 * 3,       3 * 4 * 13 * 17,
    4 * 14,           4 * 3,           3 * 6 * 3,   6 * 3,
    2 * 3,            6 * 3,           3 * 3,       5,
    2 * 3,            2 * 12,          2 * 3,       2 * 10 * 3,
    2 * 2 * 5,        2 * 5,           4 * 4 * 17,  1 * 3};

struct SpecTileWriter {
  EcEnc *enc = nullptr;
  int mi_cols = 0, mi_rows = 0;
  int base_q_idx = 0;
  int sb4 = 16;  // 64x64 superblocks
  std::vector<uint16_t> tables[TBL_COUNT];
  // context state
  std::vector<int32_t> above_part;            // [mi_cols]
  std::vector<int32_t> left_part;             // [sb4]
  std::vector<int32_t> above_levels[3];       // [mi_cols]
  std::vector<int32_t> above_dcsign[3];
  std::vector<int32_t> left_levels[3];        // [sb4]
  std::vector<int32_t> left_dcsign[3];
  std::vector<int32_t> skips;                 // [mi_rows*mi_cols]
  std::vector<int32_t> y_modes;
  std::vector<int32_t> mi_size;
  // inter mode state, mi-granular (general spec 7.10.2 find_mv_stack —
  // the fixed-32 fast path was retired when 32->16 SPLIT landed).
  // mirror of specav1.mvrefs.MvGrid
  int gw = 0, gh = 0;
  std::vector<int8_t> mi_ref;   // 0 intra, -1 uncoded, 1.. = ref frame
  std::vector<int32_t> mi_mvr, mi_mvc;
  std::vector<int8_t> mi_n4w, mi_n4h;  // coding-block dims in mi units
  std::vector<uint8_t> mi_newmv;
  // RefFrameSignBias by reference frame (stw_set_sign_bias), and the
  // inter walk's counts: inter blocks, GOLDEN blocks, extra-search
  // candidates negated for their sign bias
  int sign_bias[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t n_inter = 0, n_golden = 0, n_flips = 0;
  int sb_row = 0;
  // tile-row placement: this writer's first mi row within the frame,
  // and the FRAME's total mi rows (spec MV clamping is frame-relative
  // while availability/contexts are tile-local)
  int row0 = 0, frame_mi_rows = 0;
  // loop-restoration per-RU syntax (luma WIENER only; spec 5.11.57):
  // choice[ur*ucols+uc] = -1 off, else index into taps (ntaps x 3);
  // subexp refs reset per tile (fresh writer per tile)
  int lr_size = 0, lr_urows = 0, lr_ucols = 0, lr_ntaps = 0;
  std::vector<int32_t> lr_choice;
  std::vector<int32_t> lr_taps;
  int lr_ref[2][3] = {{3, -7, 15}, {3, -7, 15}};
  // scans (+ inverse: raster position -> scan index, for the linear
  // eob sweep — ~900 random gathers per 32x32 txb replaced by one
  // sequential pass)
  std::vector<int> scan32_r, scan32_c, scan16_r, scan16_c;
  std::vector<int> scan8_r, scan8_c;
  std::vector<int> inv32, inv16, inv8;
  // per-txb scratch (hoisted: a fresh vector per txb dominated
  // profile; uint8 keeps the 36x36 halo inside one L1 page)
  std::vector<uint8_t> lvl_scratch;

  uint16_t *tbl(TableId id, int idx) { return &tables[id][idx]; }
};

// CDF row accessors (index math mirrors FrameContext shapes)
inline uint16_t *partition_cdf(SpecTileWriter *w, int bsl, int ctx) {
  return w->tbl(TBL_PARTITION, ((bsl - 1) * 4 + ctx) * 11);
}
inline uint16_t *skip_cdf(SpecTileWriter *w, int ctx) {
  return w->tbl(TBL_SKIP, ctx * 3);
}
inline uint16_t *kf_y_mode_cdf(SpecTileWriter *w, int a, int l) {
  return w->tbl(TBL_KF_Y_MODE, (a * 5 + l) * 14);
}
inline uint16_t *angle_delta_cdf(SpecTileWriter *w, int d) {
  return w->tbl(TBL_ANGLE_DELTA, d * 8);
}
inline uint16_t *uv_mode_cdf(SpecTileWriter *w, int cfl, int ym) {
  return w->tbl(TBL_UV_MODE, (cfl * 13 + ym) * 15);
}
inline uint16_t *txb_skip_cdf(SpecTileWriter *w, int txs, int ctx) {
  return w->tbl(TBL_TXB_SKIP, (txs * 13 + ctx) * 3);
}
inline uint16_t *eob_pt_cdf(SpecTileWriter *w, int eob_size, int ptype,
                            int emctx, int *nsyms) {
  int id, width;
  switch (eob_size) {
    case 16: id = TBL_EOB_PT_16; width = 6; break;
    case 32: id = TBL_EOB_PT_32; width = 7; break;
    case 64: id = TBL_EOB_PT_64; width = 8; break;
    case 128: id = TBL_EOB_PT_128; width = 9; break;
    case 256: id = TBL_EOB_PT_256; width = 10; break;
    case 512: id = TBL_EOB_PT_512; width = 11; break;
    default: id = TBL_EOB_PT_1024; width = 12; break;
  }
  *nsyms = width - 1;
  return w->tbl(static_cast<TableId>(id), (ptype * 2 + emctx) * width);
}
inline uint16_t *eob_extra_cdf(SpecTileWriter *w, int txs, int ptype,
                               int idx) {
  return w->tbl(TBL_EOB_EXTRA, ((txs * 2 + ptype) * 9 + idx) * 3);
}
inline uint16_t *coeff_base_eob_cdf(SpecTileWriter *w, int txs, int ptype,
                                    int ctx) {
  return w->tbl(TBL_COEFF_BASE_EOB, ((txs * 2 + ptype) * 4 + ctx) * 4);
}
inline uint16_t *coeff_base_cdf(SpecTileWriter *w, int txs, int ptype,
                                int ctx) {
  return w->tbl(TBL_COEFF_BASE, ((txs * 2 + ptype) * 42 + ctx) * 5);
}
inline uint16_t *coeff_br_cdf(SpecTileWriter *w, int txs, int ptype,
                              int ctx) {
  return w->tbl(TBL_COEFF_BR, ((txs * 2 + ptype) * 21 + ctx) * 5);
}
inline uint16_t *dc_sign_cdf(SpecTileWriter *w, int ptype, int ctx) {
  return w->tbl(TBL_DC_SIGN, (ptype * 3 + ctx) * 3);
}

inline void sym(SpecTileWriter *w, int s, uint16_t *cdf, int nsyms) {
  ec_enc_symbol_adapt(w->enc, s, cdf, nsyms);
}

// ---- partition ------------------------------------------------------------

// f15 (icdf of the not-split symbol = gathered SPLIT mass) for the
// edge-partition bool, per libaom partition_gather_{vert,horz}_alongside.
// vertical=false: bottom edge (HORZ vs SPLIT); true: right edge.
int split_bool_f(const uint16_t *cdf, int nsyms, bool vertical) {
  static const int kBottom[6] = {2, 3, 4, 6, 7, 9};
  static const int kRight[6] = {1, 3, 4, 5, 6, 8};
  const int *m = vertical ? kRight : kBottom;
  int probs[10];
  int prev = 32768;
  for (int i = 0; i < nsyms; ++i) {
    probs[i] = prev - cdf[i];
    prev = cdf[i];
  }
  int psplit = 0;
  for (int k = 0; k < 6; ++k)
    if (m[k] < nsyms) psplit += probs[m[k]];
  return psplit < 1 ? 1 : (psplit > 32767 ? 32767 : psplit);
}

// --- loop restoration per-RU syntax (spec 5.11.57/5.11.58) -----------
// Writer duals of decode_signed_subexp_with_ref_bool; literal
// (equiprobable) bits through the range coder.

static void lr_write_quniform(SpecTileWriter *w, int n, int v) {
  if (n <= 1) return;
  int l = 0;  // bit_length(n): smallest l with n < (1 << l)
  for (int t = n; t; t >>= 1) ++l;
  int m = (1 << l) - n;
  if (v < m) {
    ec_enc_literal(w->enc, v, l - 1);
  } else {
    int t = v + m;
    ec_enc_literal(w->enc, t >> 1, l - 1);
    ec_enc_literal(w->enc, t & 1, 1);
  }
}

static void lr_write_subexp_fin(SpecTileWriter *w, int n, int k, int v) {
  int i = 0, mk = 0;
  for (;;) {
    int b2 = i ? k + i - 1 : k;
    int a = 1 << b2;
    if (n <= mk + 3 * a) {
      lr_write_quniform(w, n - mk, v - mk);
      return;
    }
    if (v >= mk + a) {
      ec_enc_literal(w->enc, 1, 1);
      ++i;
      mk += a;
    } else {
      ec_enc_literal(w->enc, 0, 1);
      ec_enc_literal(w->enc, v - mk, b2);
      return;
    }
  }
}

static int lr_recenter_nonneg(int r, int v) {
  if (v > (r << 1)) return v;
  if (v >= r) return (v - r) << 1;
  return ((r - v) << 1) - 1;
}

static void lr_write_signed_subexp(SpecTileWriter *w, int low, int high,
                                   int k, int ref, int v) {
  int n = high - low;
  int r = ref - low;
  int x = v - low;
  int rec = ((r << 1) <= n) ? lr_recenter_nonneg(r, x)
                            : lr_recenter_nonneg(n - 1 - r, n - 1 - x);
  lr_write_subexp_fin(w, n, k, rec);
}

static const int kWienerTapsMin[3] = {-5, -23, -17};
static const int kWienerTapsMax[3] = {10, 8, 46};
static const int kWienerTapsK[3] = {1, 2, 3};

// Emit the LR units whose top-left rounds into this SB (luma plane
// only; frame-relative rows via w->row0).
static void write_lr(SpecTileWriter *w, int r_local, int c) {
  if (!w->lr_size) return;
  int r = w->row0 + r_local;
  int size = w->lr_size;
  int urs = (r * 4 + size - 1) / size;
  int ure = ((r + 16) * 4 + size - 1) / size;
  if (ure > w->lr_urows) ure = w->lr_urows;
  int ucs = (c * 4 + size - 1) / size;
  int uce = ((c + 16) * 4 + size - 1) / size;
  if (uce > w->lr_ucols) uce = w->lr_ucols;
  for (int ur = urs; ur < ure; ++ur) {
    for (int uc = ucs; uc < uce; ++uc) {
      int32_t ch = w->lr_choice[ur * w->lr_ucols + uc];
      uint16_t *cdf = w->tbl(TBL_RESTORE_WIENER, 0);
      sym(w, ch >= 0 ? 1 : 0, cdf, 2);
      if (ch < 0) continue;
      // 6-wide rows: (v0, v1, v2, h0, h1, h2); pass 0 = vertical
      const int32_t *taps = &w->lr_taps[ch * 6];
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = 0; j < 3; ++j) {
          int32_t t = taps[pass * 3 + j];
          lr_write_signed_subexp(w, kWienerTapsMin[j],
                                 kWienerTapsMax[j] + 1, kWienerTapsK[j],
                                 w->lr_ref[pass][j], t);
          w->lr_ref[pass][j] = t;
        }
      }
    }
  }
}

void write_partition(SpecTileWriter *w, int r, int c, int bsize, int part) {
  int w4 = kBlockSizes[bsize].w4;
  int bsl = log2i(w4);
  int half = w4 >> 1;
  bool has_rows = (r + half) < w->mi_rows;
  bool has_cols = (c + half) < w->mi_cols;
  int above = (r > 0) ? ((w->above_part[c] >> bsl) & 1) : 0;
  int left = (c > 0) ? ((w->left_part[(r - w->sb_row) & 15] >> bsl) & 1) : 0;
  int ctx = left * 2 + above;
  static const int kNsyms[6] = {0, 4, 10, 10, 10, 8};
  uint16_t *cdf = partition_cdf(w, bsl, ctx);
  if (!(has_rows && has_cols)) {
    if (!(has_rows || has_cols)) return;  // implicit SPLIT, no bits
    // bottom edge (has_cols only) -> vertical=false; right edge -> true
    int f = split_bool_f(cdf, kNsyms[bsl], /*vertical=*/!has_cols);
    ec_enc_bool(w->enc, part == PARTITION_SPLIT ? 1 : 0, f);
    return;
  }
  sym(w, part, cdf, kNsyms[bsl]);
}

void update_partition_ctx(SpecTileWriter *w, int r, int c, int bsize) {
  int w4 = kBlockSizes[bsize].w4, h4 = kBlockSizes[bsize].h4;
  int ac = part_ctx_byte(w4), lc = part_ctx_byte(h4);
  int bw4 = imin(w4, w->mi_cols - c);
  int bh4 = imin(h4, w->mi_rows - r);
  for (int i = 0; i < bw4; ++i) w->above_part[c + i] = ac;
  int lr = (r - w->sb_row) & 15;
  for (int i = 0; i < bh4 && lr + i < w->sb4; ++i) w->left_part[lr + i] = lc;
}

// ---- block header ---------------------------------------------------------

void write_block_intra(SpecTileWriter *w, int r, int c, int bsize, int skip,
                       int y_mode, int uv_mode, int angle_y = 0,
                       int angle_uv = 0) {
  int ctx = 0;
  if (r > 0) ctx += w->skips[(r - 1) * w->mi_cols + c];
  if (c > 0) ctx += w->skips[r * w->mi_cols + c - 1];
  sym(w, skip, skip_cdf(w, ctx), 2);
  int am = (r > 0) ? w->y_modes[(r - 1) * w->mi_cols + c] : 0;
  int lm = (c > 0) ? w->y_modes[r * w->mi_cols + c - 1] : 0;
  sym(w, y_mode, kf_y_mode_cdf(w, kIntraModeContext[am],
                               kIntraModeContext[lm]), 13);
  if (bsize >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
    sym(w, angle_y + 3, angle_delta_cdf(w, y_mode - V_PRED), 7);
  int maxd = imax(kBlockSizes[bsize].w4, kBlockSizes[bsize].h4) * 4;
  int cfl_allowed = maxd <= 32 ? 1 : 0;
  sym(w, uv_mode, uv_mode_cdf(w, cfl_allowed, y_mode),
      cfl_allowed ? 14 : 13);
  if (bsize >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
    sym(w, angle_uv + 3, angle_delta_cdf(w, uv_mode - V_PRED), 7);
  int bw4 = imin(kBlockSizes[bsize].w4, w->mi_cols - c);
  int bh4 = imin(kBlockSizes[bsize].h4, w->mi_rows - r);
  for (int i = 0; i < bh4; ++i)
    for (int j = 0; j < bw4; ++j) {
      size_t mi = (size_t)(r + i) * w->mi_cols + c + j;
      w->skips[mi] = skip;
      w->y_modes[mi] = y_mode;
      w->mi_size[mi] = bsize;
      w->mi_ref[mi] = 0;  // intra
      w->mi_n4w[mi] = (int8_t)kBlockSizes[bsize].w4;
      w->mi_n4h[mi] = (int8_t)kBlockSizes[bsize].h4;
    }
  if (skip) {  // reset entropy ctx over block area, all planes
    int lr = (r - w->sb_row) & 15;
    for (int p = 0; p < 3; ++p) {
      for (int j = 0; j < bw4; ++j) {
        w->above_levels[p][c + j] = 0;
        w->above_dcsign[p][c + j] = 0;
      }
      for (int i = 0; i < bh4; ++i) {
        w->left_levels[p][lr + i] = 0;
        w->left_dcsign[p][lr + i] = 0;
      }
    }
  }
}

// ---- coefficients ---------------------------------------------------------

int txb_skip_ctx(SpecTileWriter *w, int plane, int x, int y, int tw, int th,
                 int ssx, int ssy) {
  if (!plane) ssx = ssy = 0;
  int c4 = (x >> 2) << ssx;
  int r4 = (y >> 2) << ssy;
  int w4 = (tw >> 2) << ssx;
  int h4 = (th >> 2) << ssy;
  w4 = imin(w4, w->mi_cols - c4);
  h4 = imin(h4, w->mi_rows - r4);
  const int32_t *a = &w->above_levels[plane][c4];
  int lr = r4 % w->sb4;
  const int32_t *l = &w->left_levels[plane][lr];
  int mr = imin(y >> 2, w->mi_rows - 1);
  int mc = imin(x >> 2, w->mi_cols - 1);
  if (plane == 0) {
    int bsize = w->mi_size[mr * w->mi_cols + mc];
    if (kBlockSizes[bsize].w4 * 4 == tw && kBlockSizes[bsize].h4 * 4 == th)
      return 0;
    int top = 0, left = 0;
    for (int i = 0; i < w4; ++i) top = imax(top, a[i]);
    for (int i = 0; i < h4; ++i) left = imax(left, l[i]);
    top = imin(top, 4);
    left = imin(left, 4);
    int mx = imin(top | left, 4);
    int mn = imin(imin(top, left), 4);
    return kSkipContexts[mn][mx];
  }
  int above_nz = 0, left_nz = 0;
  for (int i = 0; i < w4; ++i) above_nz |= (a[i] != 0);
  for (int i = 0; i < h4; ++i) left_nz |= (l[i] != 0);
  mr = imin((y << ssy) >> 2, w->mi_rows - 1);
  mc = imin((x << ssx) >> 2, w->mi_cols - 1);
  int bsize = w->mi_size[mr * w->mi_cols + mc];
  int cbw = imax(kBlockSizes[bsize].w4 >> ssx, 1) * 4;
  int cbh = imax(kBlockSizes[bsize].h4 >> ssy, 1) * 4;
  int offset = (cbw * cbh <= tw * th) ? 7 : 10;
  return offset + above_nz + left_nz;
}

int dc_sign_ctx(SpecTileWriter *w, int plane, int x, int y, int tw, int th,
                int ssx, int ssy) {
  if (!plane) ssx = ssy = 0;
  int c4 = (x >> 2) << ssx;
  int r4 = (y >> 2) << ssy;
  int w4 = (tw >> 2) << ssx;
  int h4 = (th >> 2) << ssy;
  w4 = imin(w4, w->mi_cols - c4);
  h4 = imin(h4, w->mi_rows - r4);
  int s = 0;
  for (int i = 0; i < w4; ++i) s += w->above_dcsign[plane][c4 + i];
  int lr = r4 % w->sb4;
  for (int i = 0; i < h4; ++i) s += w->left_dcsign[plane][lr + i];
  return s < 0 ? 1 : (s > 0 ? 2 : 0);
}

void set_coef_ctx(SpecTileWriter *w, int plane, int x, int y, int tw, int th,
                  int cul, int dcsign, int ssx, int ssy) {
  if (!plane) ssx = ssy = 0;
  int c4 = (x >> 2) << ssx;
  int r4 = (y >> 2) << ssy;
  int w4 = (tw >> 2) << ssx;
  int h4 = (th >> 2) << ssy;
  w4 = imin(w4, w->mi_cols - c4);
  h4 = imin(h4, w->mi_rows - r4);
  for (int i = 0; i < w4; ++i) {
    w->above_levels[plane][c4 + i] = cul;
    w->above_dcsign[plane][c4 + i] = dcsign;
  }
  int lr = r4 % w->sb4;
  for (int i = 0; i < h4; ++i) {
    w->left_levels[plane][lr + i] = cul;
    w->left_dcsign[plane][lr + i] = dcsign;
  }
}

void write_golomb(SpecTileWriter *w, int value) {
  int x = value + 1;
  int length = 0;
  for (int v = x; v; v >>= 1) ++length;
  for (int i = 0; i < length - 1; ++i) ec_enc_literal(w->enc, 0, 1);
  ec_enc_literal(w->enc, 1, 1);
  for (int i = length - 2; i >= 0; --i)
    ec_enc_literal(w->enc, (x >> i) & 1, 1);
}

// Emit one transform block.  vals: pointer into the frame-level plane of
// quantized levels at the txb origin with row stride `stride`.
// DCT-only path (TX_CLASS_2D, no tx_type symbol for >16 sq_up; callers
// emitting 16x16 luma must pass intra_ext_tx support — not yet needed).
void write_coeffs(SpecTileWriter *w, int plane, int x, int y, int tx,
                  const int32_t *vals, int stride, int ssx, int ssy,
                  int is_inter = 0, int intra_dir = 0) {
  TxDim td = kTxSizes[tx];
  int tw = td.w, th = td.h;
  int cw = imin(tw, 32), ch = imin(th, 32);
  int ptype = plane > 0 ? 1 : 0;
  int txs = txsize_entropy_ctx(tx);
  int ctx_skip = txb_skip_ctx(w, plane, x, y, tw, th, ssx, ssy);
  // eob in scan order
  const std::vector<int> &sr =
      (cw == 32) ? w->scan32_r : (cw == 16 ? w->scan16_r : w->scan8_r);
  const std::vector<int> &sc =
      (cw == 32) ? w->scan32_c : (cw == 16 ? w->scan16_c : w->scan8_c);
  int n = cw * ch;
  int eob = 0;
  if (cw == ch) {
    // linear sweep + inverse scan: sequential loads instead of up to
    // n random gathers (identical eob by construction)
    const std::vector<int> &inv =
        (cw == 32) ? w->inv32 : (cw == 16 ? w->inv16 : w->inv8);
    for (int rr = 0; rr < ch; ++rr) {
      const int32_t *row = vals + (size_t)rr * stride;
      const int *irow = inv.data() + rr * cw;
      for (int cc = 0; cc < cw; ++cc)
        if (row[cc] != 0 && irow[cc] >= eob) eob = irow[cc] + 1;
    }
  } else {
    for (int si = n - 1; si >= 0; --si)
      if (vals[sr[si] * stride + sc[si]] != 0) {
        eob = si + 1;
        break;
      }
  }
  if (eob == 0) {
    sym(w, 1, txb_skip_cdf(w, txs, ctx_skip), 2);
    set_coef_ctx(w, plane, x, y, tw, th, 0, 0, ssx, ssy);
    return;
  }
  sym(w, 0, txb_skip_cdf(w, txs, ctx_skip), 2);
  // luma tx_type: intra 32x32 is DCTONLY (no symbol); inter 32x32 is
  // TX_SET_INTER_3 {IDTX, DCT} -> signal DCT (index 1); inter 16x16 is
  // EXT_TX_SET_DTT9_IDTX_1DDCT (12 syms, DCT_DCT = index 3); inter 8x8
  // is EXT_TX_SET_ALL16 (16 syms, DCT_DCT = index 7)
  if (plane == 0 && is_inter && tx_size_sqr_up(tx) == 3) {
    int sqr = tx_size_sqr(tx);
    sym(w, 1, w->tbl(TBL_INTER_EXT_TX, (3 * 4 + sqr) * 17), 2);
  } else if (plane == 0 && is_inter && tx_size_sqr_up(tx) == 2) {
    int sqr = tx_size_sqr(tx);
    sym(w, 3, w->tbl(TBL_INTER_EXT_TX, (2 * 4 + sqr) * 17), 12);
  } else if (plane == 0 && is_inter && tx_size_sqr_up(tx) <= 1) {
    int sqr = tx_size_sqr(tx);
    sym(w, 7, w->tbl(TBL_INTER_EXT_TX, (1 * 4 + sqr) * 17), 16);
  } else if (plane == 0 && !is_inter && tx_size_sqr_up(tx) == 2) {
    // intra 16x16: TX_SET_DTT4_IDTX (5 syms) {IDTX, DCT, ADST_ADST,
    // ADST_DCT, DCT_ADST}; the coded type is mode-derived (spec
    // Mode_To_Txfm, mirrored by the device encoder's quad_y /
    // strip path) — mode order DC,V,H,D45,D135,D113,D157,D203,D67,
    // SMOOTH,SMOOTH_V,SMOOTH_H,PAETH
    static const int kDtt4Idx[13] = {1, 3, 4, 1, 2, 3, 4, 4, 3,
                                     2, 3, 4, 2};
    int sqr = tx_size_sqr(tx);
    sym(w, kDtt4Idx[intra_dir],
        w->tbl(TBL_INTRA_EXT_TX,
               ((2 * 4 + sqr) * 13 + intra_dir) * 17), 5);
  }
  // eob_pt
  int nsyms;
  uint16_t *ecdf = eob_pt_cdf(w, n, ptype, /*emctx=*/0, &nsyms);
  int t = eob_pt_group(eob);
  sym(w, t - 1, ecdf, nsyms);
  if (t >= 3) {
    int offset = eob - (1 << (t - 2)) - 1;
    int extra = (offset >> (t - 3)) & 1;
    sym(w, extra, eob_extra_cdf(w, txs, ptype, t - 3), 2);
    for (int i = 1; i < t - 2; ++i)
      ec_enc_literal(w->enc, (offset >> (t - 3 - i)) & 1, 1);
  }
  // reverse scan: base (+br)
  int lstride = cw + 4;
  size_t lsize = (size_t)(ch + 4) * lstride;
  if (w->lvl_scratch.size() < lsize) w->lvl_scratch.resize(lsize);
  std::vector<uint8_t> &levels = w->lvl_scratch;
  std::memset(levels.data(), 0, lsize);
  for (int si = eob - 1; si >= 0; --si) {
    int rr = sr[si], cc = sc[si];
    int v = vals[rr * stride + cc];
    int lvl = v < 0 ? -v : v;
    if (si == eob - 1) {
      int cec = base_eob_ctx(si, cw, ch);
      sym(w, imin(lvl, 3) - 1, coeff_base_eob_cdf(w, txs, ptype, cec), 3);
    } else {
      int bctx = base_ctx_2d(levels.data(), lstride, rr, cc);
      sym(w, imin(lvl, 3), coeff_base_cdf(w, txs, ptype, bctx), 4);
    }
    if (lvl > 2) {
      int brctx = br_ctx_2d(levels.data(), lstride, rr, cc);
      int rem = imin(lvl, 15) - 3;
      for (int it = 0; it < 4; ++it) {
        int k = imin(rem, 3);
        sym(w, k, coeff_br_cdf(w, imin(txs, 3), ptype, brctx), 4);
        rem -= k;
        if (k < 3) break;
      }
    }
    levels[rr * lstride + cc] = imin(lvl, 127);
  }
  // forward scan: signs + golomb
  int cul = 0, dcsign = 0;
  for (int si = 0; si < eob; ++si) {
    int rr = sr[si], cc = sc[si];
    int v = vals[rr * stride + cc];
    if (v == 0) continue;
    int sign = v < 0 ? 1 : 0;
    int lvl = v < 0 ? -v : v;
    if (si == 0) {
      int sctx = dc_sign_ctx(w, plane, x, y, tw, th, ssx, ssy);
      sym(w, sign, dc_sign_cdf(w, ptype, sctx), 2);
      dcsign = sign ? -1 : 1;
    } else {
      ec_enc_literal(w->enc, sign, 1);
    }
    if (lvl > 14) write_golomb(w, lvl - 15);
    cul += lvl;
  }
  set_coef_ctx(w, plane, x, y, tw, th, imin(cul, 63), dcsign, ssx, ssy);
}

// ---- inter mode machinery (uniform 32x32 grid) ----------------------------
// Port of mvrefs.find_mv_stack specialized to the fixed grid every
// block is 8x8 mi: the outer ring scans are unreachable (processed
// rows/cols = 6 >= all ring offsets), leaving above/left/top-right
// (nearest) plus the top-left point and the short-stack extension.

constexpr int kRefCat = 640;

struct MvStack {
  int mv[8][2];
  int wgt[8];
  int n = 0;
  int nearest_n = 0;
  int newmv_ctx = 0, refmv_ctx = 0, zeromv_ctx = 0;
  void refmv(int idx, int *r, int *c) const {
    if (idx < n) { *r = mv[idx][0]; *c = mv[idx][1]; }
    else { *r = 0; *c = 0; }
  }
};

inline void stack_add(MvStack *s, int mvr, int mvc, int weight) {
  for (int i = 0; i < s->n; ++i)
    if (s->mv[i][0] == mvr && s->mv[i][1] == mvc) {
      s->wgt[i] += weight;
      return;
    }
  if (s->n < 8) {
    s->mv[s->n][0] = mvr;
    s->mv[s->n][1] = mvc;
    s->wgt[s->n] = weight;
    ++s->n;
  }
}

// has_top_right, rect-aware (port of mvrefs._has_top_right; sb_mi=16)
inline bool has_top_right_g(int mi_row, int mi_col, int bw4, int bh4) {
  int bs = imax(bw4, bh4);
  if (bs > 16) return false;
  int mask_row = mi_row & 15, mask_col = mi_col & 15;
  bool has_tr = !((mask_row & bs) && (mask_col & bs));
  for (int b = bs; b < 16; b <<= 1) {
    if (mask_col & b) {
      if ((mask_col & (2 * b)) && (mask_row & (2 * b))) {
        has_tr = false;
        break;
      }
    } else {
      break;
    }
  }
  if (bw4 < bh4) {                       // vertical rectangle
    bool is_sec = ((mi_col + bw4) & (bh4 - 1)) == 0;
    if (!is_sec) has_tr = true;
  } else if (bw4 > bh4) {                // horizontal rectangle
    if (mi_row & (bw4 - 1)) has_tr = false;
  }
  return has_tr;
}

// general spec 7.10.2 MV stack (port of specav1.mvrefs.find_mv_stack,
// which is fuzz-validated against libaom across mixed partition trees).
// Rows/cols are TILE-LOCAL; MV clamping is frame-relative vertically
// via w->row0 / w->frame_mi_rows (full-width tile rows).
struct ScanState {
  MvStack *s;
  int row_match = 0, col_match = 0, newmv_count = 0;
};

constexpr int kMvrefRowCols = 3;

inline void add_candidate_g(SpecTileWriter *w, ScanState *st, int cr,
                            int cc, int ref_frame, int weight,
                            bool is_row, bool count_newmv) {
  size_t ci = (size_t)cr * w->mi_cols + cc;
  int cand_ref = w->mi_ref[ci];
  if (cand_ref <= 0) return;             // intra or uncoded
  if (cand_ref != ref_frame) return;
  if (is_row) st->row_match += 1; else st->col_match += 1;
  if (count_newmv && w->mi_newmv[ci]) st->newmv_count += 1;
  stack_add(st->s, w->mi_mvr[ci], w->mi_mvc[ci], weight);
}

inline int scan_row_g(SpecTileWriter *w, ScanState *st, int mi_row,
                      int mi_col, int bw4, int bh4, int row_offset,
                      int ref_frame, int max_row_offset,
                      bool count_newmv) {
  (void)bh4;
  int end_mi = imin(imin(bw4, w->mi_cols - mi_col), 16);
  int col_offset = 0;
  if (row_offset < -1 || row_offset > 1) {
    col_offset = 1;
    if ((mi_col & 1) && bw4 < 2) col_offset -= 1;
  }
  bool use_step_16 = bw4 >= 16;
  int processed_rows = 0;
  int row = mi_row + row_offset;
  if (row < 0 || row >= w->mi_rows) return processed_rows;
  for (int i = 0; i < end_mi;) {
    int cc = mi_col + col_offset + i;
    if (cc < 0 || cc >= w->mi_cols) break;
    int n4w = w->mi_n4w[(size_t)row * w->mi_cols + cc];
    if (n4w <= 0) break;
    int length = imin(bw4, n4w);
    if (use_step_16) length = imax(4, length);
    else if (row_offset < -1 || row_offset > 1) length = imax(length, 2);
    int weight = 2;
    if (bw4 >= 2 && bw4 <= n4w) {
      int inc = imin(-max_row_offset + row_offset + 1,
                     (int)w->mi_n4h[(size_t)row * w->mi_cols + cc]);
      weight = imax(weight, inc);
      processed_rows = inc - row_offset - 1;
    }
    add_candidate_g(w, st, row, cc, ref_frame, length * weight,
                    /*is_row=*/true, count_newmv);
    i += length;
  }
  return processed_rows;
}

inline int scan_col_g(SpecTileWriter *w, ScanState *st, int mi_row,
                      int mi_col, int bw4, int bh4, int col_offset_arg,
                      int ref_frame, int max_col_offset,
                      bool count_newmv) {
  (void)bw4;
  int end_mi = imin(imin(bh4, w->mi_rows - mi_row), 16);
  int row_offset = 0;
  if (col_offset_arg < -1 || col_offset_arg > 1) {
    row_offset = 1;
    if ((mi_row & 1) && bh4 < 2) row_offset -= 1;
  }
  bool use_step_16 = bh4 >= 16;
  int processed_cols = 0;
  int col = mi_col + col_offset_arg;
  if (col < 0 || col >= w->mi_cols) return processed_cols;
  for (int i = 0; i < end_mi;) {
    int cr = mi_row + row_offset + i;
    if (cr < 0 || cr >= w->mi_rows) break;
    int n4h = w->mi_n4h[(size_t)cr * w->mi_cols + col];
    if (n4h <= 0) break;
    int length = imin(bh4, n4h);
    if (use_step_16) length = imax(4, length);
    else if (col_offset_arg < -1 || col_offset_arg > 1)
      length = imax(length, 2);
    int weight = 2;
    if (bh4 >= 2 && bh4 <= n4h) {
      int inc = imin(-max_col_offset + col_offset_arg + 1,
                     (int)w->mi_n4w[(size_t)cr * w->mi_cols + col]);
      weight = imax(weight, inc);
      processed_cols = inc - col_offset_arg - 1;
    }
    add_candidate_g(w, st, cr, col, ref_frame, length * weight,
                    /*is_row=*/false, count_newmv);
    i += length;
  }
  return processed_cols;
}

inline void scan_point_g(SpecTileWriter *w, ScanState *st, int mi_row,
                         int mi_col, int dr, int dc, int ref_frame,
                         bool count_newmv) {
  int r = mi_row + dr, c = mi_col + dc;
  if (r < 0 || r >= w->mi_rows || c < 0 || c >= w->mi_cols) return;
  if (w->mi_n4w[(size_t)r * w->mi_cols + c] <= 0) return;
  add_candidate_g(w, st, r, c, ref_frame, 2 * 2, /*is_row=*/true,
                  count_newmv);
}

void find_mv_stack_g(SpecTileWriter *w, int mi_row, int mi_col, int bw4,
                     int bh4, int ref_frame, MvStack *s) {
  s->n = 0;
  ScanState st;
  st.s = s;
  bool up_available = mi_row > 0;
  bool left_available = mi_col > 0;
  int row_adj = (bh4 < 2 && (mi_row & 1)) ? 1 : 0;
  int col_adj = (bw4 < 2 && (mi_col & 1)) ? 1 : 0;
  int max_row_offset = 0;
  if (up_available) {
    max_row_offset = -(kMvrefRowCols << 1) + row_adj;
    if (bh4 < 2) max_row_offset = -(2 << 1) + row_adj;
    max_row_offset = imax(max_row_offset, -mi_row);
  }
  int max_col_offset = 0;
  if (left_available) {
    max_col_offset = -(kMvrefRowCols << 1) + col_adj;
    if (bw4 < 2) max_col_offset = -(2 << 1) + col_adj;
    max_col_offset = imax(max_col_offset, -mi_col);
  }
  int processed_rows = 0, processed_cols = 0;
  if (max_row_offset <= -1)
    processed_rows = scan_row_g(w, &st, mi_row, mi_col, bw4, bh4, -1,
                                ref_frame, max_row_offset, true);
  if (max_col_offset <= -1)
    processed_cols = scan_col_g(w, &st, mi_row, mi_col, bw4, bh4, -1,
                                ref_frame, max_col_offset, true);
  if (has_top_right_g(w->row0 + mi_row, mi_col, bw4, bh4))
    scan_point_g(w, &st, mi_row, mi_col, -1, bw4, ref_frame, true);

  int close_matches = (st.row_match > 0) + (st.col_match > 0);
  int nearest_count = s->n;
  s->nearest_n = nearest_count;
  for (int i = 0; i < nearest_count; ++i) s->wgt[i] += kRefCat;

  scan_point_g(w, &st, mi_row, mi_col, -1, -1, ref_frame, false);
  for (int idx = 2; idx <= kMvrefRowCols; ++idx) {
    int row_offset = -(idx << 1) + 1 + row_adj;
    int col_offset = -(idx << 1) + 1 + col_adj;
    if (-row_offset <= -max_row_offset && -row_offset > processed_rows)
      scan_row_g(w, &st, mi_row, mi_col, bw4, bh4, row_offset,
                 ref_frame, max_row_offset, false);
    if (-col_offset <= -max_col_offset && -col_offset > processed_cols)
      scan_col_g(w, &st, mi_row, mi_col, bw4, bh4, col_offset,
                 ref_frame, max_col_offset, false);
  }

  int total_matches = (st.row_match > 0) + (st.col_match > 0);
  if (close_matches == 0) {
    s->newmv_ctx = imin(total_matches, 1);
    s->refmv_ctx = total_matches;
  } else if (close_matches == 1) {
    s->newmv_ctx = 3 - imin(st.newmv_count, 1);
    s->refmv_ctx = 2 + total_matches;
  } else {
    s->newmv_ctx = 5 - imin(st.newmv_count, 1);
    s->refmv_ctx = 5;
  }
  s->zeromv_ctx = 0;

  // sort by weight (two bubble passes: nearest region, then rest)
  int ln = nearest_count;
  while (ln > 0) {
    int nr = 0;
    for (int i = 1; i < ln; ++i)
      if (s->wgt[i - 1] < s->wgt[i]) {
        std::swap(s->wgt[i - 1], s->wgt[i]);
        std::swap(s->mv[i - 1][0], s->mv[i][0]);
        std::swap(s->mv[i - 1][1], s->mv[i][1]);
        nr = i;
      }
    ln = nr;
  }
  ln = s->n;
  while (ln > nearest_count) {
    int nr = nearest_count;
    for (int i = nearest_count + 1; i < ln; ++i)
      if (s->wgt[i - 1] < s->wgt[i]) {
        std::swap(s->wgt[i - 1], s->wgt[i]);
        std::swap(s->mv[i - 1][0], s->mv[i][0]);
        std::swap(s->mv[i - 1][1], s->mv[i][1]);
        nr = i;
      }
    ln = nr;
  }

  // single-ref extension when short (spec 7.10.2.12 extra search):
  // accepts ANY inter ref, its vector negated where that ref's sign
  // bias differs from ref_frame's (departure: the original never
  // negates); both passes walk at most min(w4, h4) units
  if (s->n < 2) {
    auto process_single = [&](int cr, int cc) {
      size_t ci = (size_t)cr * w->mi_cols + cc;
      int cand_ref = w->mi_ref[ci];
      if (cand_ref <= 0) return;
      int mvr = w->mi_mvr[ci], mvc = w->mi_mvc[ci];
      if (w->sign_bias[cand_ref] != w->sign_bias[ref_frame]) {
        mvr = -mvr;
        mvc = -mvc;
        ++w->n_flips;
      }
      stack_add(s, mvr, mvc, 2);
    };
    int num4x4 = imin(imin(16, bw4), imin(16, bh4));
    for (int i = 0; max_row_offset <= -1 && i < num4x4 && s->n < 2;) {
      int cc = mi_col + i;
      if (cc >= w->mi_cols ||
          w->mi_n4w[(size_t)(mi_row - 1) * w->mi_cols + cc] <= 0)
        break;
      process_single(mi_row - 1, cc);
      i += w->mi_n4w[(size_t)(mi_row - 1) * w->mi_cols + cc];
    }
    for (int i = 0; max_col_offset <= -1 && i < num4x4 && s->n < 2;) {
      int cr = mi_row + i;
      if (cr >= w->mi_rows ||
          w->mi_n4h[(size_t)cr * w->mi_cols + mi_col - 1] <= 0)
        break;
      process_single(cr, mi_col - 1);
      i += w->mi_n4h[(size_t)cr * w->mi_cols + mi_col - 1];
    }
  }

  // clamp to the frame-relative MV bounds (tile rows are full-width;
  // vertical bounds use the FRAME mi extent via row0/frame_mi_rows)
  int g_row = w->row0 + mi_row;
  int bw8 = bw4 * 32, bh8 = bh4 * 32;
  int lo_c = -(mi_col * 32) - bw8 - 128;
  int hi_c = (w->mi_cols - bw4 - mi_col) * 32 + bw8 + 128;
  int lo_r = -(g_row * 32) - bh8 - 128;
  int hi_r = (w->frame_mi_rows - bh4 - g_row) * 32 + bh8 + 128;
  for (int i = 0; i < s->n; ++i) {
    s->mv[i][0] = imin(imax(s->mv[i][0], lo_r), hi_r);
    s->mv[i][1] = imin(imax(s->mv[i][1], lo_c), hi_c);
  }
}

inline int intra_inter_ctx_g(SpecTileWriter *w, int r, int c) {
  bool has_a = r > 0, has_l = c > 0;
  bool ai = has_a && w->mi_ref[(size_t)(r - 1) * w->mi_cols + c] == 0;
  bool li = has_l && w->mi_ref[(size_t)r * w->mi_cols + c - 1] == 0;
  if (has_a && has_l) return (ai && li) ? 3 : (int)(ai || li);
  if (has_a || has_l) return 2 * (int)(has_a ? ai : li);
  return 0;
}

inline int balance_ctx(int c0, int c1) {
  if (c0 == c1) return 1;
  return c0 < c1 ? 0 : 2;
}

void single_ref_ctxs_g(SpecTileWriter *w, int r, int c, int *p1, int *p3,
                       int *p4, int *p5) {
  // mirror of mvrefs.single_ref_ctxs / _neighbor_ref_counts: the
  // above and left mi (tile-local r/c, so >0 IS the tile condition)
  int n[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (r > 0) {
    int ref = w->mi_ref[(size_t)(r - 1) * w->mi_cols + c];
    if (ref > 0) ++n[ref];
  }
  if (c > 0) {
    int ref = w->mi_ref[(size_t)r * w->mi_cols + c - 1];
    if (ref > 0) ++n[ref];
  }
  int fwd = n[1] + n[2] + n[3] + n[4];
  int bwd = n[5] + n[6] + n[7];
  *p1 = balance_ctx(fwd, bwd);          // fwd vs bwd
  *p3 = balance_ctx(n[1] + n[2], n[3] + n[4]);  // L+L2 vs L3+GOLDEN
  *p4 = balance_ctx(n[1], n[2]);        // LAST vs LAST2
  *p5 = balance_ctx(n[3], n[4]);        // LAST3 vs GOLDEN
}

// spec YMode ids continuing intra numbering (tile.py)
constexpr int NEARESTMV = 13;
constexpr int GLOBALMV = 15;
constexpr int NEWMV = 16;

void write_mv_component(SpecTileWriter *w, int comp, int d) {
  int sign = d < 0 ? 1 : 0;
  int mag = sign ? -d : d;
  int z = mag - 1;
  sym(w, sign, w->tbl(TBL_MV_SIGN, comp * 3), 2);
  if (z < 16) {
    sym(w, 0, w->tbl(TBL_MV_CLASSES, comp * 12), 11);
    int bit = z >> 3;
    sym(w, bit, w->tbl(TBL_MV_CLASS0, comp * 3), 2);
    sym(w, (z >> 1) & 3, w->tbl(TBL_MV_CLASS0_FP, (comp * 2 + bit) * 5), 4);
  } else {
    int bl = 0;
    for (int v = z; v; v >>= 1) ++bl;
    int cls = bl - 4;  // z.bit_length() - 4
    sym(w, cls, w->tbl(TBL_MV_CLASSES, comp * 12), 11);
    int offset = z - (2 << (cls + 2));
    int dbits = offset >> 3;
    for (int i = 0; i < cls; ++i)
      sym(w, (dbits >> i) & 1, w->tbl(TBL_MV_BITS, (comp * 10 + i) * 3), 2);
    sym(w, (offset >> 1) & 3, w->tbl(TBL_MV_FP, comp * 5), 4);
  }
}

void write_mv(SpecTileWriter *w, int dr, int dc) {
  int joint = (dr ? 2 : 0) | (dc ? 1 : 0);
  sym(w, joint, w->tbl(TBL_MV_JOINT, 0), 4);
  if (dr) write_mv_component(w, 0, dr);
  if (dc) write_mv_component(w, 1, dc);
}

void reset_coef_ctx_block(SpecTileWriter *w, int r, int c, int bw4, int bh4) {
  int lr = (r - w->sb_row) & 15;
  for (int p = 0; p < 3; ++p) {
    for (int j = 0; j < bw4; ++j) {
      w->above_levels[p][c + j] = 0;
      w->above_dcsign[p][c + j] = 0;
    }
    for (int i = 0; i < bh4; ++i) {
      w->left_levels[p][lr + i] = 0;
      w->left_dcsign[p][lr + i] = 0;
    }
  }
}

void finish_block_common_g(SpecTileWriter *w, int r, int c, int bsize,
                           int skip, int store_mode, int ref, int mvr,
                           int mvc, int is_newmv) {
  int w4 = kBlockSizes[bsize].w4, h4 = kBlockSizes[bsize].h4;
  int bh4 = imin(h4, w->mi_rows - r), bw4 = imin(w4, w->mi_cols - c);
  for (int i = 0; i < bh4; ++i)
    for (int j = 0; j < bw4; ++j) {
      size_t mi = (size_t)(r + i) * w->mi_cols + c + j;
      w->skips[mi] = skip;
      w->y_modes[mi] = store_mode;
      w->mi_size[mi] = bsize;
      w->mi_ref[mi] = (int8_t)ref;
      w->mi_mvr[mi] = mvr;
      w->mi_mvc[mi] = mvc;
      w->mi_n4w[mi] = (int8_t)w4;
      w->mi_n4h[mi] = (int8_t)h4;
      w->mi_newmv[mi] = (uint8_t)is_newmv;
    }
  if (skip) reset_coef_ctx_block(w, r, c, bw4, bh4);
}

void write_skip_and_inter(SpecTileWriter *w, int r, int c, int skip,
                          int is_inter) {
  int ctx = 0;
  if (r > 0) ctx += w->skips[(r - 1) * w->mi_cols + c];
  if (c > 0) ctx += w->skips[r * w->mi_cols + c - 1];
  sym(w, skip, skip_cdf(w, ctx), 2);
  int ii = intra_inter_ctx_g(w, r, c);
  sym(w, is_inter, w->tbl(TBL_INTRA_INTER, ii * 3), 2);
}

void write_block_inter_g(SpecTileWriter *w, int r, int c, int bsize,
                         int skip, int y_mode, int mvr, int mvc,
                         const MvStack *s, int ref = 1) {
  write_skip_and_inter(w, r, c, skip, 1);
  int p1, p3, p4, p5;
  single_ref_ctxs_g(w, r, c, &p1, &p3, &p4, &p5);
  // single-reference tree (tile.py read_ref_frames mirror):
  // b1=0 forward group; b3 selects {LAST,LAST2} vs {LAST3,GOLDEN};
  // then b4 (LAST vs LAST2) or b5 (LAST3 vs GOLDEN)
  int golden = ref == 4;
  sym(w, 0, w->tbl(TBL_SINGLE_REF, (p1 * 6 + 0) * 3), 2);
  sym(w, golden, w->tbl(TBL_SINGLE_REF, (p3 * 6 + 2) * 3), 2);
  if (golden)
    sym(w, 1, w->tbl(TBL_SINGLE_REF, (p5 * 6 + 4) * 3), 2);
  else
    sym(w, 0, w->tbl(TBL_SINGLE_REF, (p4 * 6 + 3) * 3), 2);
  sym(w, y_mode != NEWMV ? 1 : 0, w->tbl(TBL_NEWMV, s->newmv_ctx * 3), 2);
  if (y_mode != NEWMV) {
    sym(w, y_mode != GLOBALMV ? 1 : 0,
        w->tbl(TBL_ZEROMV, s->zeromv_ctx * 3), 2);
    if (y_mode != GLOBALMV)
      sym(w, y_mode != NEARESTMV ? 1 : 0,
          w->tbl(TBL_REFMV, s->refmv_ctx * 3), 2);
  }
  if (y_mode == NEWMV) {
    if (s->n > 1) {
      // drl_ctx(0): weights vs REF_CAT_LEVEL
      int a = s->wgt[0] >= kRefCat, b = (1 < s->n) && s->wgt[1] >= kRefCat;
      int dctx = (a && b) ? 0 : (a ? 1 : (!a && !b ? 2 : 0));
      sym(w, 0, w->tbl(TBL_DRL, dctx * 3), 2);
    }
    int pr, pc;
    s->refmv(0, &pr, &pc);
    write_mv(w, mvr - pr, mvc - pc);
  }
  finish_block_common_g(w, r, c, bsize, skip, /*DC*/ 0, ref, mvr, mvc,
                        y_mode == NEWMV);
}

void write_block_intra_if_g(SpecTileWriter *w, int r, int c, int bsize,
                            int skip, int y_mode, int uv_mode) {
  write_skip_and_inter(w, r, c, skip, 0);
  // SIZE_GROUP: {16x16}=2, {32x32}=3 (spec size_group_lookup)
  int sg = bsize >= BLOCK_32X32 ? 3 : 2;
  sym(w, y_mode, w->tbl(TBL_IF_Y_MODE, sg * 14), 13);
  if (y_mode >= V_PRED && y_mode <= D67_PRED)
    sym(w, 3, angle_delta_cdf(w, y_mode - V_PRED), 7);
  sym(w, uv_mode, uv_mode_cdf(w, 1, y_mode), 14);
  if (uv_mode >= V_PRED && uv_mode <= D67_PRED)
    sym(w, 3, angle_delta_cdf(w, uv_mode - V_PRED), 7);
  finish_block_common_g(w, r, c, bsize, skip, y_mode, 0, 0, 0, 0);
}

void start_sb_row(SpecTileWriter *w, int mi_row);

// ---- 16px bottom strip (true dims for height % 32 == 16) ------------------
// The last 4 mi rows code as edge-SPLIT 16x16 blocks: luma V_PRED with
// a coded 16x16 DCT residual, chroma V_PRED prediction-only (all_zero
// chroma txbs keep every transform square/2-D).  Strip blocks are
// intra in every frame type (spec decoder parity: 5.11.x edge
// partitions; cost is ~2% of one block row).

void write_strip_block(SpecTileWriter *w, int r, int c, int skip,
                       int key_frame, const int32_t *ylv, int ystride,
                       const int32_t *ulv, const int32_t *vlv,
                       int cstride) {
  const int V = 1;  // V_PRED
  write_partition(w, r, c, BLOCK_16X16, PARTITION_NONE);
  if (key_frame) {
    write_block_intra(w, r, c, BLOCK_16X16, skip, V, V);
  } else {
    // intra block in an inter frame
    int ctx = 0;
    if (r > 0) ctx += w->skips[(r - 1) * w->mi_cols + c];
    if (c > 0) ctx += w->skips[r * w->mi_cols + c - 1];
    sym(w, skip, skip_cdf(w, ctx), 2);
    int ii = intra_inter_ctx_g(w, r, c);
    sym(w, 0, w->tbl(TBL_INTRA_INTER, ii * 3), 2);
    // SIZE_GROUP[BLOCK_16X16] = 2
    sym(w, V, w->tbl(TBL_IF_Y_MODE, 2 * 14), 13);
    sym(w, 3, angle_delta_cdf(w, V - V_PRED), 7);
    sym(w, V, uv_mode_cdf(w, 1, V), 14);
    sym(w, 3, angle_delta_cdf(w, V - V_PRED), 7);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        size_t mi = (size_t)(r + i) * w->mi_cols + c + j;
        w->skips[mi] = skip;
        w->y_modes[mi] = V;
        w->mi_size[mi] = BLOCK_16X16;
        w->mi_ref[mi] = 0;  // intra
        w->mi_n4w[mi] = 4;
        w->mi_n4h[mi] = 4;
      }
    if (skip) reset_coef_ctx_block(w, r, c, 4, 4);
  }
  if (!skip) {
    int x0 = c * 4, y0 = r * 4;
    write_coeffs(w, 0, x0, y0, TX_16X16, &ylv[y0 * ystride + x0],
                 ystride, 1, 1, /*is_inter=*/0, /*intra_dir=*/V);
    int cx = x0 >> 1, cy = y0 >> 1;
    write_coeffs(w, 1, cx, cy, TX_8X8, &ulv[cy * cstride + cx],
                 cstride, 1, 1);
    write_coeffs(w, 2, cx, cy, TX_8X8, &vlv[cy * cstride + cx],
                 cstride, 1, 1);
  }
  update_partition_ctx(w, r, c, BLOCK_16X16);
}

void start_sb_row(SpecTileWriter *w, int mi_row) {
  w->sb_row = mi_row;
  std::fill(w->left_part.begin(), w->left_part.end(), 0);
  for (int p = 0; p < 3; ++p) {
    std::fill(w->left_levels[p].begin(), w->left_levels[p].end(), 0);
    std::fill(w->left_dcsign[p].begin(), w->left_dcsign[p].end(), 0);
  }
}

}  // namespace

// ---- C API ----------------------------------------------------------------

extern "C" {

SpecTileWriter *stw_create(int mi_cols, int mi_rows, int base_q_idx) {
  auto *w = new SpecTileWriter();
  w->mi_cols = mi_cols;
  w->mi_rows = mi_rows;
  w->frame_mi_rows = mi_rows;
  w->base_q_idx = base_q_idx;
  for (int i = 0; i < TBL_COUNT; ++i)
    w->tables[i].assign(kTableSize[i], 0);
  w->above_part.assign(mi_cols, 0);
  w->left_part.assign(w->sb4, 0);
  for (int p = 0; p < 3; ++p) {
    w->above_levels[p].assign(mi_cols, 0);
    w->above_dcsign[p].assign(mi_cols, 0);
    w->left_levels[p].assign(w->sb4, 0);
    w->left_dcsign[p].assign(w->sb4, 0);
  }
  w->skips.assign(mi_rows * mi_cols, 0);
  w->y_modes.assign(mi_rows * mi_cols, 0);
  w->mi_size.assign(mi_rows * mi_cols, 0);
  w->gw = (mi_cols + 7) / 8;
  w->gh = (mi_rows + 7) / 8;
  w->mi_ref.assign((size_t)mi_rows * mi_cols, -1);
  w->mi_mvr.assign((size_t)mi_rows * mi_cols, 0);
  w->mi_mvc.assign((size_t)mi_rows * mi_cols, 0);
  w->mi_n4w.assign((size_t)mi_rows * mi_cols, 0);
  w->mi_n4h.assign((size_t)mi_rows * mi_cols, 0);
  w->mi_newmv.assign((size_t)mi_rows * mi_cols, 0);
  build_zigzag(32, 32, &w->scan32_r, &w->scan32_c);
  build_zigzag(16, 16, &w->scan16_r, &w->scan16_c);
  build_zigzag(8, 8, &w->scan8_r, &w->scan8_c);
  auto invert = [](const std::vector<int> &sr, const std::vector<int> &sc,
                   int cw, std::vector<int> *inv) {
    inv->assign(sr.size(), -1);
    for (size_t si = 0; si < sr.size(); ++si)
      (*inv)[sr[si] * cw + sc[si]] = static_cast<int>(si);
  };
  invert(w->scan32_r, w->scan32_c, 32, &w->inv32);
  invert(w->scan16_r, w->scan16_c, 16, &w->inv16);
  invert(w->scan8_r, w->scan8_c, 8, &w->inv8);
  return w;
}

// Place this writer as one tile row of a taller frame.
void stw_set_lr(SpecTileWriter *w, int unit_size, int urows, int ucols,
                const int32_t *choice, const int32_t *taps, int ntaps) {
  w->lr_size = unit_size;
  w->lr_urows = urows;
  w->lr_ucols = ucols;
  w->lr_ntaps = ntaps;
  w->lr_choice.assign(choice, choice + (size_t)urows * ucols);
  w->lr_taps.assign(taps, taps + (size_t)ntaps * 6);
}

void stw_set_tile_row(SpecTileWriter *w, int row0_mi, int frame_mi_rows) {
  w->row0 = row0_mi;
  w->frame_mi_rows = frame_mi_rows;
}

// RefFrameSignBias of the frame, indexed by reference frame (8 ints;
// LAST_FRAME = 1): the extra MV search negates across a difference.
void stw_set_sign_bias(SpecTileWriter *w, const int32_t *bias) {
  for (int i = 0; i < 8; ++i) w->sign_bias[i] = bias[i] ? 1 : 0;
}

// The counts of the inter tiles written so far: out[0] inter blocks,
// out[1] of them GOLDEN, out[2] extra-search candidates negated.
void stw_counts(const SpecTileWriter *w, int64_t *out) {
  out[0] = w->n_inter;
  out[1] = w->n_golden;
  out[2] = w->n_flips;
}

void stw_destroy(SpecTileWriter *w) {
  if (w->enc) ec_enc_destroy(w->enc);
  delete w;
}

// Copies a FrameContext table (uint16, ICDF+counter rows).  Returns 0 on
// shape mismatch.
int stw_set_cdf(SpecTileWriter *w, int table_id, const uint16_t *data,
                int n_u16) {
  if (table_id < 0 || table_id >= TBL_COUNT) return 0;
  if (n_u16 != kTableSize[table_id]) return 0;
  std::memcpy(w->tables[table_id].data(), data, n_u16 * sizeof(uint16_t));
  return 1;
}

// Encode one intra tile on a fixed 32x32 grid (mi dims multiples of 16;
// frames are SB-padded upstream).  Block grid is gh x gw with
// gw = mi_cols/8.  ylv: [mi_rows*4][ystride] int32 quantized levels;
// ulv/vlv at 4:2:0 half resolution with stride cstride.
// splits[gi] (nullable): 1 = code the 32 block as four 16x16 intra
// blocks (z-order quadrants) with per-quadrant y16/uv16/ang16/sk16
// [gh*gw*4] and TX_16X16 luma + TX_8X8 chroma levels read from the
// same level planes at quadrant offsets.
// Returns tile byte count written to out, or -1 if cap is too small.
int64_t stw_encode_intra32(SpecTileWriter *w, const int32_t *y_modes,
                           const int32_t *uv_modes, const int32_t *angles,
                           const int32_t *skips,
                           const int32_t *strip_skip,
                           const int32_t *ylv, int ystride,
                           const int32_t *ulv, const int32_t *vlv,
                           int cstride, uint8_t *out, int64_t cap,
                           const int32_t *splits, const int32_t *y16,
                           const int32_t *uv16, const int32_t *ang16,
                           const int32_t *sk16) {
  if (w->enc) ec_enc_destroy(w->enc);
  w->enc = ec_enc_create();
  int gw = w->mi_cols / 8;
  for (int sb_r = 0; sb_r < w->mi_rows; sb_r += 16) {
    start_sb_row(w, sb_r);
    for (int sb_c = 0; sb_c < w->mi_cols; sb_c += 16) {
      write_lr(w, sb_r, sb_c);
      write_partition(w, sb_r, sb_c, BLOCK_64X64, PARTITION_SPLIT);
      // z-order children
      const int child[4][2] = {{sb_r, sb_c},
                               {sb_r, sb_c + 8},
                               {sb_r + 8, sb_c},
                               {sb_r + 8, sb_c + 8}};
      for (int k = 0; k < 4; ++k) {
        int br = child[k][0], bc = child[k][1];
        if (br >= w->mi_rows || bc >= w->mi_cols) continue;
        if (w->mi_rows - br == 4 && strip_skip) {
          // 16px bottom strip: edge-SPLIT into two 16x16 blocks
          write_partition(w, br, bc, BLOCK_32X32, PARTITION_SPLIT);
          for (int j = 0; j < 2; ++j) {
            int c16 = bc + j * 4;
            if (c16 >= w->mi_cols) continue;
            write_strip_block(w, br, c16, strip_skip[c16 / 4],
                              /*key_frame=*/1, ylv, ystride, ulv, vlv,
                              cstride);
          }
          continue;
        }
        int gi = (br / 8) * gw + (bc / 8);
        if (splits && splits[gi]) {
          // RD-chosen 32->16 SPLIT: four 16x16 intra blocks in z-order
          write_partition(w, br, bc, BLOCK_32X32, PARTITION_SPLIT);
          for (int q = 0; q < 4; ++q) {
            int qr = br + (q >> 1) * 4, qc = bc + (q & 1) * 4;
            int qi = gi * 4 + q;
            int qskip = sk16[qi];
            write_partition(w, qr, qc, BLOCK_16X16, PARTITION_NONE);
            write_block_intra(w, qr, qc, BLOCK_16X16, qskip, y16[qi],
                              uv16[qi], ang16[qi]);
            if (!qskip) {
              int x0 = qc * 4, y0 = qr * 4;
              write_coeffs(w, 0, x0, y0, TX_16X16,
                           &ylv[y0 * ystride + x0], ystride, 1, 1,
                           /*is_inter=*/0, /*intra_dir=*/y16[qi]);
              int cx = x0 >> 1, cy = y0 >> 1;
              write_coeffs(w, 1, cx, cy, TX_8X8,
                           &ulv[cy * cstride + cx], cstride, 1, 1);
              write_coeffs(w, 2, cx, cy, TX_8X8,
                           &vlv[cy * cstride + cx], cstride, 1, 1);
            }
            update_partition_ctx(w, qr, qc, BLOCK_16X16);
          }
          continue;
        }
        int skip = skips[gi];
        write_partition(w, br, bc, BLOCK_32X32, PARTITION_NONE);
        write_block_intra(w, br, bc, BLOCK_32X32, skip, y_modes[gi],
                          uv_modes[gi], angles ? angles[gi] : 0);
        if (!skip) {
          int x0 = bc * 4, y0 = br * 4;
          write_coeffs(w, 0, x0, y0, TX_32X32, &ylv[y0 * ystride + x0],
                       ystride, 1, 1);
          int cx = x0 >> 1, cy = y0 >> 1;
          write_coeffs(w, 1, cx, cy, TX_16X16, &ulv[cy * cstride + cx],
                       cstride, 1, 1);
          write_coeffs(w, 2, cx, cy, TX_16X16, &vlv[cy * cstride + cx],
                       cstride, 1, 1);
        }
        update_partition_ctx(w, br, bc, BLOCK_32X32);
      }
    }
  }
  int32_t sz = ec_enc_done(w->enc, out, cap > INT32_MAX ? INT32_MAX
                                                        : (int32_t)cap);
  ec_enc_destroy(w->enc);
  w->enc = nullptr;
  return sz;
}

// Encode one single-reference inter tile on the fixed 32x32 grid.
// modes[gi]: 0 = intra DC fallback, 1 = inter (motion-compensated).
// mvs: [gh*gw*2] int32 final MVs in 1/8-pel (even; rows then cols
// interleaved per cell).  The inter Y mode per block is derived from
// the MV-prediction stack: NEARESTMV when the MV equals the stack
// head, GLOBALMV when (0,0), else NEWMV (residual vs the stack head).
// One inter coding unit (32x32 NONE or a 16x16 SPLIT quadrant): mode
// derivation from the MV stack, block header, coefficients.
static void encode_inter_unit(SpecTileWriter *w, int br, int bc,
                              int bsize, int is_inter, int skip,
                              int mvr, int mvc, const int32_t *ylv,
                              int ystride, const int32_t *ulv,
                              const int32_t *vlv, int cstride,
                              int ref = 1) {
  if (is_inter) {
    ++w->n_inter;
    if (ref == 4) ++w->n_golden;
    MvStack s;
    int b4 = kBlockSizes[bsize].w4;
    find_mv_stack_g(w, br, bc, b4, b4, ref, &s);
    int pr, pc;
    s.refmv(0, &pr, &pc);
    int ym;
    if (mvr == pr && mvc == pc) ym = NEARESTMV;
    else if (mvr == 0 && mvc == 0) ym = GLOBALMV;
    else ym = NEWMV;
    write_block_inter_g(w, br, bc, bsize, skip, ym, mvr, mvc, &s, ref);
  } else {
    write_block_intra_if_g(w, br, bc, bsize, skip, /*DC*/ 0, /*DC*/ 0);
  }
  if (!skip) {
    int x0 = bc * 4, y0 = br * 4;
    int ytx = bsize == BLOCK_32X32 ? TX_32X32 : TX_16X16;
    int ctx_ = bsize == BLOCK_32X32 ? TX_16X16 : TX_8X8;
    write_coeffs(w, 0, x0, y0, ytx, &ylv[y0 * ystride + x0],
                 ystride, 1, 1, is_inter);
    int cx = x0 >> 1, cy = y0 >> 1;
    write_coeffs(w, 1, cx, cy, ctx_, &ulv[cy * cstride + cx],
                 cstride, 1, 1, is_inter);
    write_coeffs(w, 2, cx, cy, ctx_, &vlv[cy * cstride + cx],
                 cstride, 1, 1, is_inter);
  }
}

// Encode one single-reference inter tile on the 32x32 grid with
// optional per-block 32->16 SPLIT.  modes[gi]: 0 = intra DC fallback,
// 1 = inter.  mvs: [gh*gw*2] final 32-block MVs (1/8 pel).
// splits[gi] (nullable): 1 = code this 32 block as four 16x16 inter
// blocks using mvs16 [gh*gw*4*2] (z-order quadrants) and skips16
// [gh*gw*4].  The per-block Y mode is derived from the spec MV stack:
// NEARESTMV when the MV equals the stack head, GLOBALMV when (0,0),
// else NEWMV (residual vs the stack head).
int64_t stw_encode_inter32(SpecTileWriter *w, const int32_t *modes,
                           const int32_t *mvs, const int32_t *skips,
                           const int32_t *strip_skip,
                           const int32_t *ylv, int ystride,
                           const int32_t *ulv, const int32_t *vlv,
                           int cstride, uint8_t *out, int64_t cap,
                           const int32_t *splits, const int32_t *mvs16,
                           const int32_t *skips16) {
  if (w->enc) ec_enc_destroy(w->enc);
  w->enc = ec_enc_create();
  std::fill(w->mi_ref.begin(), w->mi_ref.end(), (int8_t)-1);
  std::fill(w->mi_n4w.begin(), w->mi_n4w.end(), (int8_t)0);
  std::fill(w->mi_n4h.begin(), w->mi_n4h.end(), (int8_t)0);
  int gw = w->gw;
  for (int sb_r = 0; sb_r < w->mi_rows; sb_r += 16) {
    start_sb_row(w, sb_r);
    for (int sb_c = 0; sb_c < w->mi_cols; sb_c += 16) {
      write_lr(w, sb_r, sb_c);
      write_partition(w, sb_r, sb_c, BLOCK_64X64, PARTITION_SPLIT);
      const int child[4][2] = {{sb_r, sb_c},
                               {sb_r, sb_c + 8},
                               {sb_r + 8, sb_c},
                               {sb_r + 8, sb_c + 8}};
      for (int k = 0; k < 4; ++k) {
        int br = child[k][0], bc = child[k][1];
        if (br >= w->mi_rows || bc >= w->mi_cols) continue;
        if (w->mi_rows - br == 4 && strip_skip) {
          write_partition(w, br, bc, BLOCK_32X32, PARTITION_SPLIT);
          for (int j = 0; j < 2; ++j) {
            int c16 = bc + j * 4;
            if (c16 >= w->mi_cols) continue;
            write_strip_block(w, br, c16, strip_skip[c16 / 4],
                              /*key_frame=*/0, ylv, ystride, ulv, vlv,
                              cstride);
          }
          continue;
        }
        int gr = br / 8, gc = bc / 8;
        int gi = gr * gw + gc;
        // modes[gi]: 0 = intra DC fallback, 1 = inter LAST,
        // 4 = inter GOLDEN (spec ref ids; SPLIT quadrants inherit)
        int is_inter = modes[gi] != 0;
        int ref = modes[gi] == 4 ? 4 : 1;
        if (splits && splits[gi] && is_inter) {
          // 32 -> four 16x16 quadrants (z-order), each its own MV
          write_partition(w, br, bc, BLOCK_32X32, PARTITION_SPLIT);
          const int q[4][2] = {{0, 0}, {0, 4}, {4, 0}, {4, 4}};
          for (int qi = 0; qi < 4; ++qi) {
            int qr = br + q[qi][0], qc = bc + q[qi][1];
            if (qr >= w->mi_rows || qc >= w->mi_cols) continue;
            write_partition(w, qr, qc, BLOCK_16X16, PARTITION_NONE);
            encode_inter_unit(w, qr, qc, BLOCK_16X16, 1,
                              skips16[gi * 4 + qi],
                              mvs16[(gi * 4 + qi) * 2],
                              mvs16[(gi * 4 + qi) * 2 + 1],
                              ylv, ystride, ulv, vlv, cstride, ref);
            update_partition_ctx(w, qr, qc, BLOCK_16X16);
          }
          continue;
        }
        write_partition(w, br, bc, BLOCK_32X32, PARTITION_NONE);
        encode_inter_unit(w, br, bc, BLOCK_32X32, is_inter, skips[gi],
                          mvs[gi * 2], mvs[gi * 2 + 1], ylv, ystride,
                          ulv, vlv, cstride, ref);
        update_partition_ctx(w, br, bc, BLOCK_32X32);
      }
    }
  }
  int32_t sz = ec_enc_done(w->enc, out, cap > INT32_MAX ? INT32_MAX
                                                        : (int32_t)cap);
  ec_enc_destroy(w->enc);
  w->enc = nullptr;
  return sz;
}

// Scatter the device's sparse level transfer (MSB-first bitmask +
// packed int16 values in position order — spec_engine._pack_outputs)
// into a dense int32 plane buffer.  Replaces numpy's
// unpackbits→astype→fancy-index chain (~9 ms/frame at 1080p, three
// 8x-expanded temporaries) with one pass that skips zero 64-bit mask
// words.  `out` must hold `nbits` int32s; trailing pad bits of the
// final partial byte are guaranteed zero by packbits.
// `pre_zeroed`: caller allocated `out` with calloc-fresh pages (numpy
// np.zeros) — skip the 4*nbits memset; only pages holding nonzeros
// fault in.
void stw_densify(const uint8_t *maskbytes, int64_t nbits,
                 const int16_t *vals, int32_t *out, int pre_zeroed) {
  if (!pre_zeroed) std::memset(out, 0, (size_t)nbits * sizeof(int32_t));
  int64_t nbytes = (nbits + 7) / 8;
  int64_t full = nbits / 8;  // bytes whose 8 bits are all in-range
  int64_t vi = 0;
  int64_t i = 0;
  for (; i + 8 <= full; i += 8) {
    uint64_t w8;
    std::memcpy(&w8, maskbytes + i, 8);
    if (w8 == 0) continue;
    for (int b = 0; b < 8; ++b) {
      uint32_t byte = maskbytes[i + b];
      if (!byte) continue;
      int64_t base = (i + b) * 8;
      do {
        int bit = __builtin_clz(byte << 24);  // MSB-first within byte
        out[base + bit] = vals[vi++];
        byte &= ~(0x80000000u >> (bit + 24));
      } while (byte);
    }
  }
  for (; i < nbytes; ++i) {
    uint32_t byte = maskbytes[i];
    if (!byte) continue;
    int64_t base = i * 8;
    do {
      int bit = __builtin_clz(byte << 24);
      int64_t pos = base + bit;
      if (pos < nbits) out[pos] = vals[vi++];
      byte &= ~(0x80000000u >> (bit + 24));
    } while (byte);
  }
}

}  // extern "C"
