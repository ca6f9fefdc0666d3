// Copied from av1tpu/encoder/entropy/native/ec.cc (the decoder half serves
// the legacy tile reader, av1tpu_torch/legacy/native/tile.cc).
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

// ---------------------------------------------------------------------------
// Decoder (32-bit window, all-ones complement convention)

struct EcDec {
  const uint8_t *buf;
  const uint8_t *end;
  const uint8_t *bptr;
  uint32_t dif;
  uint32_t rng;
  int cnt;
};

static void dec_refill(EcDec *d) {
  uint32_t dif = d->dif;
  int cnt = d->cnt;
  const uint8_t *bptr = d->bptr;
  const uint8_t *end = d->end;
  int s = 32 - 9 - (cnt + 15);
  for (; s >= 0 && bptr < end; s -= 8, bptr++) {
    dif ^= static_cast<uint32_t>(bptr[0]) << s;
    cnt += 8;
  }
  if (bptr >= end) {
    cnt = 16384;  // "lots of bits": reads past end behave as zeros
  }
  d->dif = dif;
  d->cnt = cnt;
  d->bptr = bptr;
}

extern "C" EcDec *ec_dec_create(const uint8_t *buf, int32_t size) {
  EcDec *d = new EcDec;
  d->buf = buf;
  d->end = buf + size;
  d->bptr = buf;
  d->dif = (1u << 31) - 1;
  d->rng = 0x8000;
  d->cnt = -15;
  dec_refill(d);
  return d;
}

extern "C" void ec_dec_destroy(EcDec *d) { delete d; }

static int dec_normalize(EcDec *d, uint32_t dif, uint32_t rng, int ret) {
  int s = 16 - ilog_nz(rng);
  d->cnt -= s;
  d->dif = ((dif + 1) << s) - 1;
  d->rng = rng << s;
  if (d->cnt < 0) dec_refill(d);
  return ret;
}

extern "C" int ec_dec_symbol(EcDec *d, const uint16_t *icdf, int nsyms) {
  uint32_t dif = d->dif;
  uint32_t r = d->rng;
  const int N = nsyms - 1;
  uint32_t c = dif >> (32 - 16);
  uint32_t v = r;
  uint32_t u;
  int ret = -1;
  do {
    u = v;
    ++ret;
    v = ec_scale(r, icdf[ret]) + kMinProb * (N - ret);
  } while (c < v);
  dif -= static_cast<uint32_t>(v) << (32 - 16);
  r = u - v;
  return dec_normalize(d, dif, r, ret);
}

extern "C" int ec_dec_symbol_adapt(EcDec *d, uint16_t *cdf, int nsyms) {
  int ret = ec_dec_symbol(d, cdf, nsyms);
  cdf_update(cdf, ret, nsyms);
  return ret;
}

extern "C" int ec_dec_bool(EcDec *d, unsigned f15) {
  uint32_t dif = d->dif;
  uint32_t r = d->rng;
  uint32_t v = ec_scale(r, f15) + kMinProb;
  uint32_t vw = v << (32 - 16);
  int ret = 1;
  uint32_t new_r = v;
  if (dif >= vw) {
    new_r = r - v;
    dif -= vw;
    ret = 0;
  }
  return dec_normalize(d, dif, new_r, ret);
}

extern "C" int ec_dec_bool_adapt(EcDec *d, uint16_t *cdf) {
  int ret = ec_dec_bool(d, cdf[0]);
  cdf_update(cdf, ret, 2);
  return ret;
}

extern "C" uint32_t ec_dec_literal(EcDec *d, int bits) {
  uint32_t v = 0;
  for (int i = 0; i < bits; ++i) {
    v = (v << 1) | ec_dec_bool(d, kProbTop / 2);
  }
  return v;
}

extern "C" void cdf_init_uniform(uint16_t *cdf, int nsyms) {
  for (int i = 0; i < nsyms; ++i) {
    cdf[i] = static_cast<uint16_t>(kProbTop - kProbTop * (i + 1) / nsyms);
  }
  cdf[nsyms] = 0;  // adaptation counter
}
