// Copied from av1tpu/encoder/entropy/native/ec.h.
// AV1-style multisymbol adaptive range coder (daala EC lineage).
//
// The sequential host-side half of the encoder (SURVEY.md §7 "entropy"):
// 15-bit probabilities, inverse-CDF (icdf) convention where icdf[s] =
// 32768 - cdf[s], EC_PROB_SHIFT=6 truncation with EC_MIN_PROB=4 floor per
// symbol, carry-propagating byte output.  The decoder half is the
// conformance inverse path.  Replaces the entropy engine inside the
// reference's exec'd ffmpeg binary (SURVEY.md §2 #16).
#ifndef AV1TPU_EC_H_
#define AV1TPU_EC_H_

#include <cstdint>

extern "C" {

typedef struct EcEnc EcEnc;
typedef struct EcDec EcDec;

EcEnc *ec_enc_create(void);
void ec_enc_reset(EcEnc *e);
void ec_enc_destroy(EcEnc *e);

// Encode symbol s (0..nsyms-1) against an icdf table of nsyms entries
// (icdf[nsyms-1] must be 0).  _adapt variants expect nsyms+1 entries with
// the trailing adaptation counter, and update the CDF after coding.
void ec_enc_symbol(EcEnc *e, int s, const uint16_t *icdf, int nsyms);
void ec_enc_symbol_adapt(EcEnc *e, int s, uint16_t *cdf, int nsyms);
void ec_enc_bool(EcEnc *e, int val, unsigned f15);   // f15 = P(val==0) in q15
void ec_enc_bool_adapt(EcEnc *e, int val, uint16_t *cdf);  // 3-entry cdf
void ec_enc_literal(EcEnc *e, uint32_t val, int bits);     // MSB-first, p=1/2
// Serialize; returns byte count (or -1 if cap too small). Resets nothing.
int32_t ec_enc_done(EcEnc *e, uint8_t *out, int32_t cap);
// Upper bound on current output size in bytes.
int32_t ec_enc_size_hint(const EcEnc *e);
// Total bits coded so far, in 1/8 bit units (od_ec_enc_tell_frac analog,
// coarse: byte-resolution + window occupancy).
int64_t ec_enc_tell_bits(const EcEnc *e);

EcDec *ec_dec_create(const uint8_t *buf, int32_t size);
void ec_dec_destroy(EcDec *d);
int ec_dec_symbol(EcDec *d, const uint16_t *icdf, int nsyms);
int ec_dec_symbol_adapt(EcDec *d, uint16_t *cdf, int nsyms);
int ec_dec_bool(EcDec *d, unsigned f15);
int ec_dec_bool_adapt(EcDec *d, uint16_t *cdf);
uint32_t ec_dec_literal(EcDec *d, int bits);

// icdf helpers: layout [icdf[0..nsyms-1], counter]
void cdf_init_uniform(uint16_t *cdf, int nsyms);
void cdf_update(uint16_t *cdf, int val, int nsyms);

}  // extern "C"

#endif  // AV1TPU_EC_H_
