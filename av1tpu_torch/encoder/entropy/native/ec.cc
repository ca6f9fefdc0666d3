// Copied from av1tpu/encoder/entropy/native/ec.cc (the encoder half).
// AV1-style multisymbol adaptive range coder — see ec.h.
#include "ec.h"

#include <cassert>
#include <cstring>
#include <vector>

namespace {

constexpr int kProbShift = 6;     // EC_PROB_SHIFT
constexpr int kMinProb = 4;       // EC_MIN_PROB
constexpr unsigned kProbTop = 32768;

inline int ilog_nz(uint32_t x) { return 32 - __builtin_clz(x); }

// Scaled interval endpoint for a q15 cumulative value f against range r,
// with the per-remaining-symbol minimum-probability floor.
inline uint32_t ec_scale(uint32_t r, uint32_t f) {
  return ((r >> 8) * (f >> kProbShift)) >> (7 - kProbShift);
}

}  // namespace

// ---------------------------------------------------------------------------
// Encoder

struct EcEnc {
  std::vector<uint16_t> precarry;  // 16-bit staging values; carries resolved at done()
  uint64_t low;
  uint32_t rng;
  int cnt;
};

extern "C" EcEnc *ec_enc_create(void) {
  EcEnc *e = new EcEnc;
  ec_enc_reset(e);
  return e;
}

extern "C" void ec_enc_reset(EcEnc *e) {
  e->precarry.clear();
  e->low = 0;
  e->rng = 0x8000;
  e->cnt = -9;
}

extern "C" void ec_enc_destroy(EcEnc *e) { delete e; }

static void enc_normalize(EcEnc *e, uint64_t low, uint32_t rng) {
  int d = 16 - ilog_nz(rng);
  int c = e->cnt;
  int s = c + d;
  if (s >= 0) {
    c += 16;
    uint64_t m = (1ull << c) - 1;
    if (s >= 8) {
      e->precarry.push_back(static_cast<uint16_t>(low >> c));
      low &= m;
      c -= 8;
      m >>= 8;
    }
    e->precarry.push_back(static_cast<uint16_t>(low >> c));
    s = c + d - 24;
    low &= m;
  }
  e->low = low << d;
  e->rng = rng << d;
  e->cnt = s;
}

// fl/fh are icdf values: fl = (s>0) ? icdf[s-1] : 32768; fh = icdf[s].
static void enc_q15(EcEnc *e, unsigned fl, unsigned fh, int s, int nsyms) {
  uint64_t l = e->low;
  uint32_t r = e->rng;
  const int N = nsyms - 1;
  if (fl < kProbTop) {
    uint32_t u = ec_scale(r, fl) + kMinProb * (N - (s - 1));
    uint32_t v = ec_scale(r, fh) + kMinProb * (N - (s + 0));
    l += r - u;
    r = u - v;
  } else {
    r -= ec_scale(r, fh) + kMinProb * (N - (s + 0));
  }
  enc_normalize(e, l, r);
}

extern "C" void ec_enc_symbol(EcEnc *e, int s, const uint16_t *icdf,
                              int nsyms) {
  unsigned fl = (s > 0) ? icdf[s - 1] : kProbTop;
  unsigned fh = icdf[s];
  enc_q15(e, fl, fh, s, nsyms);
}

extern "C" void cdf_update(uint16_t *cdf, int val, int nsyms) {
  // Adaptation with icdf convention (libaom update_cdf semantics):
  // pull icdf[i] toward 32768 for i < val and toward 0 for i >= val.
  static const int nsymbs2speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 2};
  int count = cdf[nsyms];
  int rate = 3 + (count > 15) + (count > 31) + nsymbs2speed[nsyms];
  int tmp = kProbTop;
  for (int i = 0; i < nsyms - 1; ++i) {
    tmp = (i == val) ? 0 : tmp;
    if (tmp < cdf[i]) {
      cdf[i] -= static_cast<uint16_t>((cdf[i] - tmp) >> rate);
    } else {
      cdf[i] += static_cast<uint16_t>((tmp - cdf[i]) >> rate);
    }
  }
  cdf[nsyms] += (count < 32);
}

extern "C" void ec_enc_symbol_adapt(EcEnc *e, int s, uint16_t *cdf,
                                    int nsyms) {
  ec_enc_symbol(e, s, cdf, nsyms);
  cdf_update(cdf, s, nsyms);
}

extern "C" void ec_enc_bool(EcEnc *e, int val, unsigned f15) {
  uint64_t l = e->low;
  uint32_t r = e->rng;
  uint32_t v = ec_scale(r, f15) + kMinProb;
  if (val) l += r - v;
  r = val ? v : r - v;
  enc_normalize(e, l, r);
}

extern "C" void ec_enc_bool_adapt(EcEnc *e, int val, uint16_t *cdf) {
  ec_enc_bool(e, val, cdf[0]);
  cdf_update(cdf, val, 2);
}

extern "C" void ec_enc_literal(EcEnc *e, uint32_t val, int bits) {
  for (int i = bits - 1; i >= 0; --i) {
    ec_enc_bool(e, (val >> i) & 1, kProbTop / 2);
  }
}

extern "C" int32_t ec_enc_size_hint(const EcEnc *e) {
  return static_cast<int32_t>(e->precarry.size()) + 8;
}

extern "C" int64_t ec_enc_tell_bits(const EcEnc *e) {
  return (static_cast<int64_t>(e->precarry.size()) * 8 + e->cnt + 10) * 8;
}

extern "C" int32_t ec_enc_done(EcEnc *e, uint8_t *out, int32_t cap) {
  // Output the minimum bits ensuring correct decode regardless of what
  // follows, then resolve carries back-to-front.
  std::vector<uint16_t> buf = e->precarry;
  uint64_t l = e->low;
  int c = e->cnt;
  int s = 10;
  uint64_t m = 0x3FFF;
  uint64_t eW = ((l + m) & ~m) | (m + 1);
  s += c;
  if (s > 0) {
    uint64_t n = (1ull << (c + 16)) - 1;
    do {
      buf.push_back(static_cast<uint16_t>(eW >> (c + 16)));
      eW &= n;
      s -= 8;
      c -= 8;
      n >>= 8;
    } while (s > 0);
  }
  int32_t nbytes = static_cast<int32_t>(buf.size());
  if (nbytes > cap) return -1;
  uint32_t carry = 0;
  for (int32_t i = nbytes - 1; i >= 0; --i) {
    uint32_t v = buf[i] + carry;
    out[i] = static_cast<uint8_t>(v & 0xFF);
    carry = v >> 8;
  }
  assert(carry == 0);
  return nbytes;
}
