// Copied from av1tpu/legacy/native/tile.cc.
// Tile syntax codec: block modes, skip flags, and coefficient level maps.
//
// The host-side syntax walk over TPU-produced arrays (SURVEY.md §7: TPU
// emits per-block modes/levels; the sequential CDF-adaptive symbol coding
// happens here in C++).  Syntax per block, raster order:
//   skip(bool) · y_mode(7-sym) · uv_mode(7-sym) ·
//   [if !skip] 3 × txblock( all_zero(bool) · eob_class(+extras) ·
//                levels in reverse zigzag: base(4-sym, band ctx) ·
//                br(4-sym) · golomb tail · signs )
// All CDFs initialize uniform at tile start (this codec's normative
// default tables) and adapt per symbol.
#include <cstdint>
#include <cstring>
#include <vector>

#include "ec.h"

namespace {

constexpr int kNumIntraModes = 11;  // +D45/D67/D135/D157 (v2 alphabet)
constexpr int kEobClasses = 11;    // eob up to 2^10 = 1024 (32x32 blocks)
constexpr unsigned kHalf = 16384;  // p=0.5 in q15

// diagonal (zigzag) scan for an n x n block, raster index order
static void build_zigzag(int n, std::vector<int> &scan) {
  scan.clear();
  scan.reserve(n * n);
  for (int d = 0; d < 2 * n - 1; ++d) {
    if (d % 2 == 0) {  // up-right
      int r = d < n ? d : n - 1;
      int c = d - r;
      while (r >= 0 && c < n) scan.push_back(r * n + c), --r, ++c;
    } else {  // down-left
      int c = d < n ? d : n - 1;
      int r = d - c;
      while (c >= 0 && r < n) scan.push_back(r * n + c), --c, ++r;
    }
  }
}

static int band_of(int scan_pos, int n) {
  if (scan_pos == 0) return 0;
  if (scan_pos < n / 2) return 1;
  if (scan_pos < n * 2) return 2;
  return 3;
}

// Coefficient CDFs shared by intra and inter tiles (uniform-initialized)
struct CoeffCdfs {
  uint16_t all_zero[2][3];          // [plane_type][..]  0=luma 1=chroma
  uint16_t eob_class[2][kEobClasses + 1];
  uint16_t base[2][4][4 + 1];       // [plane][band][4sym]
  uint16_t br[2][4 + 1];
  uint16_t dc_sign[2][3];

  CoeffCdfs() {
    for (int p = 0; p < 2; ++p) {
      cdf_init_uniform(all_zero[p], 2);
      cdf_init_uniform(eob_class[p], kEobClasses);
      for (int b = 0; b < 4; ++b) cdf_init_uniform(base[p][b], 4);
      cdf_init_uniform(br[p], 4);
      cdf_init_uniform(dc_sign[p], 2);
    }
  }
};

// Intra tile CDFs
struct TileCdfs : CoeffCdfs {
  uint16_t skip[3];
  uint16_t y_mode[kNumIntraModes + 1];
  uint16_t uv_mode[kNumIntraModes + 1];

  TileCdfs() {
    cdf_init_uniform(skip, 2);
    cdf_init_uniform(y_mode, kNumIntraModes);
    cdf_init_uniform(uv_mode, kNumIntraModes);
  }
};

// Inter tile CDFs
struct InterCdfs : CoeffCdfs {
  uint16_t skip[3];
  uint16_t ref[3];          // reference select (0=last, 1=golden)
  uint16_t tx_type[4];      // luma transform: 0=DCT 1=ADST 2=IDTX
  uint16_t mv_zero[2][3];   // [component 0=y 1=x]
  uint16_t mv_sign[2][3];
  uint16_t mv_base[2][4 + 1];

  InterCdfs() {
    cdf_init_uniform(skip, 2);
    cdf_init_uniform(ref, 2);
    cdf_init_uniform(tx_type, 3);
    for (int c = 0; c < 2; ++c) {
      cdf_init_uniform(mv_zero[c], 2);
      cdf_init_uniform(mv_sign[c], 2);
      cdf_init_uniform(mv_base[c], 4);
    }
  }
};

static int eob_class_of(int eob) {  // eob >= 1
  int k = 0;
  while ((1 << k) < eob) ++k;      // smallest k with 2^k >= eob
  return k;                         // class k: eob in (2^(k-1), 2^k]
}

static void enc_golomb(EcEnc *e, uint32_t v) {  // exp-golomb of v >= 0
  uint32_t x = v + 1;
  int len = 0;
  while ((x >> len) > 1) ++len;
  for (int i = 0; i < len; ++i) ec_enc_bool(e, 0, kHalf);
  ec_enc_bool(e, 1, kHalf);
  for (int i = len - 1; i >= 0; --i) ec_enc_bool(e, (x >> i) & 1, kHalf);
}

static uint32_t dec_golomb(EcDec *d) {
  // corrupt/truncated streams must terminate: cap the prefix (a valid
  // encoder never exceeds 31 bits; past-the-end reads return drifting
  // bits that could otherwise spin or overflow)
  int len = 0;
  while (!ec_dec_bool(d, kHalf) && len < 31) ++len;
  uint32_t x = 1;
  for (int i = 0; i < len; ++i) x = (x << 1) | ec_dec_bool(d, kHalf);
  return x - 1;
}

static void encode_txblock(EcEnc *e, CoeffCdfs &cdfs, int plane_type,
                           const int32_t *levels_raster, int n,
                           const std::vector<int> &scan) {
  const int nn = n * n;
  // fast path: all-zero raster scan (common for chroma / quiet blocks)
  bool any = false;
  for (int i = 0; i < nn; ++i) {
    if (levels_raster[i]) { any = true; break; }
  }
  if (!any) {
    ec_enc_symbol_adapt(e, 1, cdfs.all_zero[plane_type], 2);
    return;
  }
  // scan-order levels + eob
  int eob = 0;
  std::vector<int32_t> lv(nn);
  for (int i = 0; i < nn; ++i) {
    lv[i] = levels_raster[scan[i]];
    if (lv[i]) eob = i + 1;
  }
  if (eob == 0) {
    ec_enc_symbol_adapt(e, 1, cdfs.all_zero[plane_type], 2);
    return;
  }
  ec_enc_symbol_adapt(e, 0, cdfs.all_zero[plane_type], 2);
  int klass = eob_class_of(eob);
  ec_enc_symbol_adapt(e, klass, cdfs.eob_class[plane_type], kEobClasses);
  if (klass > 0) {
    int lo = (1 << (klass - 1)) + 1;          // eob range [lo, 2^klass]
    ec_enc_literal(e, eob - lo, klass - 1 >= 0 ? (klass - 1) : 0);
  }
  // levels, reverse scan order (high frequencies first, AV1-style)
  for (int i = eob - 1; i >= 0; --i) {
    int32_t v = lv[i];
    uint32_t mag = v < 0 ? -v : v;
    int b = band_of(i, n);
    int basev = mag < 3 ? (int)mag : 3;
    ec_enc_symbol_adapt(e, basev, cdfs.base[plane_type][b], 4);
    if (basev == 3) {
      uint32_t extra = mag - 3;
      int brv = extra < 3 ? (int)extra : 3;
      ec_enc_symbol_adapt(e, brv, cdfs.br[plane_type], 4);
      if (brv == 3) enc_golomb(e, extra - 3);
    }
    if (mag) {
      if (i == 0)
        ec_enc_symbol_adapt(e, v < 0, cdfs.dc_sign[plane_type], 2);
      else
        ec_enc_bool(e, v < 0, kHalf);
    }
  }
}

static void decode_txblock(EcDec *d, CoeffCdfs &cdfs, int plane_type,
                           int32_t *levels_raster, int n,
                           const std::vector<int> &scan) {
  const int nn = n * n;
  std::memset(levels_raster, 0, sizeof(int32_t) * nn);
  if (ec_dec_symbol_adapt(d, cdfs.all_zero[plane_type], 2)) return;
  int klass = ec_dec_symbol_adapt(d, cdfs.eob_class[plane_type],
                                  kEobClasses);
  int eob;
  if (klass == 0) {
    eob = 1;
  } else {
    int lo = (1 << (klass - 1)) + 1;
    eob = lo + (klass - 1 > 0 ? (int)ec_dec_literal(d, klass - 1) : 0);
  }
  if (eob > nn) eob = nn;  // corrupt streams can signal eob > block size
  for (int i = eob - 1; i >= 0; --i) {
    int b = band_of(i, n);
    uint32_t mag = ec_dec_symbol_adapt(d, cdfs.base[plane_type][b], 4);
    if (mag == 3) {
      uint32_t brv = ec_dec_symbol_adapt(d, cdfs.br[plane_type], 4);
      mag += brv;
      if (brv == 3) mag += dec_golomb(d);
      if (mag > (1u << 20)) mag = 1u << 20;  // corrupt-stream clamp
    }
    int neg = 0;
    if (mag) {
      neg = (i == 0) ? ec_dec_symbol_adapt(d, cdfs.dc_sign[plane_type], 2)
                     : ec_dec_bool(d, kHalf);
    }
    levels_raster[scan[i]] = neg ? -(int32_t)mag : (int32_t)mag;
  }
}

}  // namespace

extern "C" int32_t tile_encode_intra(
    int32_t n_blocks, int32_t luma_n, int32_t chroma_n,
    const uint8_t *skips, const uint8_t *y_modes, const uint8_t *uv_modes,
    const int32_t *y_levels, const int32_t *u_levels, const int32_t *v_levels,
    uint8_t *out, int32_t cap) {
  std::vector<int> scan_y, scan_c;
  build_zigzag(luma_n, scan_y);
  build_zigzag(chroma_n, scan_c);
  const int ynn = luma_n * luma_n, cnn = chroma_n * chroma_n;
  TileCdfs cdfs;
  EcEnc *e = ec_enc_create();
  for (int32_t b = 0; b < n_blocks; ++b) {
    int skip = skips[b] ? 1 : 0;
    ec_enc_symbol_adapt(e, skip, cdfs.skip, 2);
    ec_enc_symbol_adapt(e, y_modes[b], cdfs.y_mode, kNumIntraModes);
    ec_enc_symbol_adapt(e, uv_modes[b], cdfs.uv_mode, kNumIntraModes);
    if (!skip) {
      encode_txblock(e, cdfs, 0, y_levels + (int64_t)b * ynn, luma_n, scan_y);
      encode_txblock(e, cdfs, 1, u_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
      encode_txblock(e, cdfs, 1, v_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
    }
  }
  int32_t size = ec_enc_done(e, out, cap);
  ec_enc_destroy(e);
  return size;
}

extern "C" int32_t tile_decode_intra(
    const uint8_t *data, int32_t size, int32_t n_blocks, int32_t luma_n,
    int32_t chroma_n, uint8_t *skips, uint8_t *y_modes, uint8_t *uv_modes,
    int32_t *y_levels, int32_t *u_levels, int32_t *v_levels) {
  std::vector<int> scan_y, scan_c;
  build_zigzag(luma_n, scan_y);
  build_zigzag(chroma_n, scan_c);
  const int ynn = luma_n * luma_n, cnn = chroma_n * chroma_n;
  TileCdfs cdfs;
  EcDec *d = ec_dec_create(data, size);
  for (int32_t b = 0; b < n_blocks; ++b) {
    int skip = ec_dec_symbol_adapt(d, cdfs.skip, 2);
    skips[b] = (uint8_t)skip;
    int ym = ec_dec_symbol_adapt(d, cdfs.y_mode, kNumIntraModes);
    int uvm = ec_dec_symbol_adapt(d, cdfs.uv_mode, kNumIntraModes);
    if (ym < 0 || uvm < 0) { ec_dec_destroy(d); return -1; }
    y_modes[b] = (uint8_t)ym;
    uv_modes[b] = (uint8_t)uvm;
    if (skip) {
      std::memset(y_levels + (int64_t)b * ynn, 0, sizeof(int32_t) * ynn);
      std::memset(u_levels + (int64_t)b * cnn, 0, sizeof(int32_t) * cnn);
      std::memset(v_levels + (int64_t)b * cnn, 0, sizeof(int32_t) * cnn);
    } else {
      decode_txblock(d, cdfs, 0, y_levels + (int64_t)b * ynn, luma_n, scan_y);
      decode_txblock(d, cdfs, 1, u_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
      decode_txblock(d, cdfs, 1, v_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
    }
  }
  ec_dec_destroy(d);
  return 0;
}

// ---------------------------------------------------------------------------
// Inter tiles: per block  skip(bool) · mv_diff(y,x vs raster-previous MV) ·
// [if !skip] 3 × txblock.  MV diff per component: zero(bool) · sign(bool) ·
// base(4-sym adaptive) · golomb tail for |diff|-1 >= 3.

namespace {

static void enc_mv_component(EcEnc *e, InterCdfs &cdfs, int c, int32_t diff) {
  if (diff == 0) {
    ec_enc_symbol_adapt(e, 1, cdfs.mv_zero[c], 2);
    return;
  }
  ec_enc_symbol_adapt(e, 0, cdfs.mv_zero[c], 2);
  ec_enc_symbol_adapt(e, diff < 0, cdfs.mv_sign[c], 2);
  uint32_t mag1 = (uint32_t)((diff < 0 ? -diff : diff) - 1);
  int basev = mag1 < 3 ? (int)mag1 : 3;
  ec_enc_symbol_adapt(e, basev, cdfs.mv_base[c], 4);
  if (basev == 3) enc_golomb(e, mag1 - 3);
}

static int32_t dec_mv_component(EcDec *d, InterCdfs &cdfs, int c) {
  if (ec_dec_symbol_adapt(d, cdfs.mv_zero[c], 2)) return 0;
  int neg = ec_dec_symbol_adapt(d, cdfs.mv_sign[c], 2);
  uint32_t mag1 = (uint32_t)ec_dec_symbol_adapt(d, cdfs.mv_base[c], 4);
  if (mag1 == 3) mag1 += dec_golomb(d);
  if (mag1 > (1u << 16)) mag1 = 1u << 16;  // corrupt-stream clamp
  int32_t mag = (int32_t)mag1 + 1;
  return neg ? -mag : mag;
}

}  // namespace

extern "C" int32_t tile_encode_inter(
    int32_t n_blocks, int32_t luma_n, int32_t chroma_n,
    const uint8_t *skips, const int32_t *mvs /* [n_blocks][2] */,
    const uint8_t *refs /* nullable */, int32_t use_refs,
    const uint8_t *txs /* luma tx per block */,
    const int32_t *y_levels, const int32_t *u_levels, const int32_t *v_levels,
    uint8_t *out, int32_t cap) {
  std::vector<int> scan_y, scan_c;
  build_zigzag(luma_n, scan_y);
  build_zigzag(chroma_n, scan_c);
  const int ynn = luma_n * luma_n, cnn = chroma_n * chroma_n;
  InterCdfs cdfs;
  EcEnc *e = ec_enc_create();
  int32_t pred[2] = {0, 0};
  for (int32_t b = 0; b < n_blocks; ++b) {
    int skip = skips[b] ? 1 : 0;
    ec_enc_symbol_adapt(e, skip, cdfs.skip, 2);
    if (use_refs) ec_enc_symbol_adapt(e, refs[b] ? 1 : 0, cdfs.ref, 2);
    for (int c = 0; c < 2; ++c) {
      enc_mv_component(e, cdfs, c, mvs[b * 2 + c] - pred[c]);
      pred[c] = mvs[b * 2 + c];
    }
    if (!skip) {
      ec_enc_symbol_adapt(e, txs[b] < 3 ? txs[b] : 0, cdfs.tx_type, 3);
      encode_txblock(e, cdfs, 0, y_levels + (int64_t)b * ynn, luma_n, scan_y);
      encode_txblock(e, cdfs, 1, u_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
      encode_txblock(e, cdfs, 1, v_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
    }
  }
  int32_t size = ec_enc_done(e, out, cap);
  ec_enc_destroy(e);
  return size;
}

extern "C" int32_t tile_decode_inter(
    const uint8_t *data, int32_t size, int32_t n_blocks, int32_t luma_n,
    int32_t chroma_n, int32_t use_refs, uint8_t *skips, int32_t *mvs,
    uint8_t *refs, uint8_t *txs, int32_t *y_levels, int32_t *u_levels,
    int32_t *v_levels) {
  std::vector<int> scan_y, scan_c;
  build_zigzag(luma_n, scan_y);
  build_zigzag(chroma_n, scan_c);
  const int ynn = luma_n * luma_n, cnn = chroma_n * chroma_n;
  InterCdfs cdfs;
  EcDec *d = ec_dec_create(data, size);
  int32_t pred[2] = {0, 0};
  for (int32_t b = 0; b < n_blocks; ++b) {
    int skip = ec_dec_symbol_adapt(d, cdfs.skip, 2);
    skips[b] = (uint8_t)skip;
    refs[b] = use_refs ? (uint8_t)ec_dec_symbol_adapt(d, cdfs.ref, 2) : 0;
    for (int c = 0; c < 2; ++c) {
      pred[c] += dec_mv_component(d, cdfs, c);
      mvs[b * 2 + c] = pred[c];
    }
    if (skip) {
      txs[b] = 0;
      std::memset(y_levels + (int64_t)b * ynn, 0, sizeof(int32_t) * ynn);
      std::memset(u_levels + (int64_t)b * cnn, 0, sizeof(int32_t) * cnn);
      std::memset(v_levels + (int64_t)b * cnn, 0, sizeof(int32_t) * cnn);
    } else {
      txs[b] = (uint8_t)ec_dec_symbol_adapt(d, cdfs.tx_type, 3);
      decode_txblock(d, cdfs, 0, y_levels + (int64_t)b * ynn, luma_n, scan_y);
      decode_txblock(d, cdfs, 1, u_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
      decode_txblock(d, cdfs, 1, v_levels + (int64_t)b * cnn, chroma_n,
                     scan_c);
    }
  }
  ec_dec_destroy(d);
  return 0;
}
