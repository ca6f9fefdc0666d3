// K2: all-displacement SSD refine with first-minimum argmin.
//
// Replaces the Pallas kernel av1tpu/encoder/kernels/pallas_motion.py
// (_refine_kernel, launched by refine_ssd): for each n x n source block,
// the SSD against every displacement (dy, dx) in [-r, r]^2 of its
// (n + 2r)^2 search region, and the displacement of the first strict
// minimum in dy-major order k = (dy + r) * (2r + 1) + (dx + r).  Inputs
// are block-first, blocks (B, n, n) and regions (B, R, R), int32; the TPU
// version's block-index-last layout and 128-lane padding are layout
// workarounds and are not carried over.
//
// Bound on the H100: device memory.  One call reads each block and each
// region once (n=32, B=2040: 27.2 MB of int32, 8.1 us at 3.35 TB/s);
// the 289 * n^2 multiply-adds per block (604M per call) take less at the
// card's integer rates once shared-memory traffic is out of the way.  A
// thread per displacement walking all n^2 pixels (the first version) did
// two int32 shared loads per multiply-add and ran at 3-5% of the bound.
//
// Design, main path (r = 8, n = 32 or 16, pixels in [0, 1023]):
//  * SSD = sum_window(r^2) - 2 * sum(r * b) + sum(b^2).  The window sums
//    of r^2 come from sliding row sums and then sliding column sums of
//    the staged region; sum(b^2) is taken while staging.  The inner loop
//    is the cross term alone.
//  * Register blocking: a thread owns one dy, all 17 dx and n/G block
//    rows.  It loads its region row once into registers, and every loaded
//    value feeds up to 17 sums; each block word is loaded once per row.
//    Partial cross sums of the G row groups meet through shared atomics.
//  * Narrow staging: the CTA stages its inputs as 16-bit and as packed
//    bytes and checks their range.  8-bit content runs __dp4a (four
//    u8 x u8 multiply-adds per instruction, unaligned windows by
//    __byte_perm); 10-bit content runs IMAD on the 16-bit copy.
//  * n = 16 puts four blocks in one CTA, so that its threads are busy.
//  * Exactness: at <= 10 bits every term is an integer below 2^31
//    (sum r^2, sum b^2 <= 1024 * 1023^2 = 1,071,645,696; 2 * sum r*b <=
//    2,143,291,392), and the three are combined in 64-bit, so no step
//    wraps and the SSD is exact.
// Any other input (a pixel outside [0, 1023], another n or radius) takes
// a direct path: int32 sums from device memory, wrapping as the plain
// PyTorch version's int32 arithmetic does.  The argmin packs each
// candidate into one 64-bit key (the SSD with its sign bit flipped, then
// k), so a min-reduction gives int32 order with ties to the lowest k:
// the reference's strict '<' in k order.
// A tensor-core route (the cross term as u8 mma with int32 accumulation)
// is left for when this design stops well short of the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 8;
constexpr int kS = 2 * kRadius + 1;  // displacements per axis
constexpr int kK = kS * kS;          // 289 candidates
constexpr int kDirectThreads = 320;

__device__ __forceinline__ unsigned long long make_key(int32_t ssd, int k) {
  return ((unsigned long long)((uint32_t)ssd ^ 0x80000000u) << 32) |
         (uint32_t)k;
}

__device__ __forceinline__ int32_t key_ssd(unsigned long long key) {
  return (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v = kmin(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Min over the CTA (every thread calls it); the result is valid in
// thread 0.  `scratch` holds one key per warp.
__device__ unsigned long long cta_min(unsigned long long v,
                                      unsigned long long* scratch) {
  v = warp_min(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = kmin(v, scratch[w]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ void write_result(unsigned long long key, int b,
                                             int radius, float* ssd_out,
                                             int32_t* disp_out) {
  const int S = 2 * radius + 1;
  const int k = (int)(key & 0xffffffffu);
  ssd_out[b] = (float)key_ssd(key);
  disp_out[2 * b] = k / S - radius;
  disp_out[2 * b + 1] = k % S - radius;
}

// Direct path: the min key over candidates k0, k0 + kstep, ... of block
// b, with int32 sums (modulo 2^32, as the plain version wraps).
__device__ unsigned long long direct_min_key(const int32_t* __restrict__ blk,
                                             const int32_t* __restrict__ reg,
                                             int n, int radius, int k0,
                                             int kstep) {
  const int S = 2 * radius + 1;
  const int R = n + 2 * radius;
  unsigned long long key = ~0ull;
  for (int k = k0; k < S * S; k += kstep) {
    const int dy = k / S;
    const int dx = k - dy * S;
    uint32_t acc = 0;
    for (int i = 0; i < n; ++i) {
      const int32_t* rrow = reg + (size_t)(dy + i) * R + dx;
      const int32_t* brow = blk + (size_t)i * n;
      for (int j = 0; j < n; ++j) {
        const uint32_t d = (uint32_t)__ldg(rrow + j) - (uint32_t)__ldg(brow + j);
        acc += d * d;
      }
    }
    key = kmin(key, make_key((int32_t)acc, k));
  }
  return key;
}

__global__ void __launch_bounds__(kDirectThreads)
refine_direct_kernel(const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ regions, int n, int radius,
                     float* __restrict__ ssd_out,
                     int32_t* __restrict__ disp_out) {
  __shared__ unsigned long long scratch[kDirectThreads / 32];
  const int b = blockIdx.x;
  const int R = n + 2 * radius;
  unsigned long long key = direct_min_key(
      blocks + (size_t)b * n * n, regions + (size_t)b * R * R, n, radius,
      threadIdx.x, blockDim.x);
  key = cta_min(key, scratch);
  if (threadIdx.x == 0) write_result(key, b, radius, ssd_out, disp_out);
}

constexpr int round_warps(int t) { return (t + 31) / 32 * 32; }

// N: block side; NB: blocks per CTA; G: row groups per block.
template <int N, int NB, int G>
struct Tile {
  static constexpr int R = N + 2 * kRadius;
  // pitches chosen so that 16 consecutive rows fall in distinct banks for
  // 8-byte (16-bit copy) and 4-byte (byte copy) loads: odd in 8 or 4 bytes
  static constexpr int RP16 = R + 4;
  static constexpr int BP16 = N + 4;
  static constexpr int RPW = (R / 4) | 1;
  static constexpr int BPW = (N / 4) | 1;
  static constexpr int kThreads = round_warps(NB * kS * G);
  static_assert(N % 4 == 0 && N % G == 0, "tile shape");
  static_assert(NB <= kThreads / 32, "one epilogue warp per block");

  struct __align__(16) Smem {
    uint16_t reg16[NB][R][RP16];
    uint16_t blk16[NB][N][BP16];
    uint32_t reg8[NB][R][RPW];
    uint32_t blk8[NB][N][BPW];
    int32_t rowsq[NB][R][kS];  // sum_{j<N} r[y][dx + j]^2
    int32_t win[NB][kK];       // sum over the window of r^2
    int32_t cross[NB][kK];     // sum r * b
    uint32_t bsq[NB];          // sum b^2
    unsigned long long scratch[kThreads / 32];
  };
  static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");
};

// Stage nb blocks' n x n (W = N) or R x R (W = R) int32 tiles, vectorized,
// as 16-bit and packed-byte copies; returns whether every value lies in
// [0, 1023] (ok10) and [0, 255] (ok8), and adds sum(v^2) into sq if given.
template <int W, int P16, int PW, int NB>
__device__ __forceinline__ void stage(const int32_t* __restrict__ src, int nb,
                                      uint16_t (*dst16)[W][P16],
                                      uint32_t (*dst8)[W][PW], uint32_t* sq,
                                      bool& ok10, bool& ok8) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  const int nvec = nb * W * W / 4;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int4 x = __ldg(s4 + v);
    const int e = 4 * v;
    const int bl = e / (W * W);
    const int rem = e - bl * W * W;
    const int y = rem / W;
    const int c = rem - y * W;
    const uint32_t a0 = (uint32_t)x.x, a1 = (uint32_t)x.y,
                   a2 = (uint32_t)x.z, a3 = (uint32_t)x.w;
    const uint32_t any = a0 | a1 | a2 | a3;
    ok10 = ok10 && (any & ~1023u) == 0;
    ok8 = ok8 && (any & ~255u) == 0;
    *reinterpret_cast<uint2*>(&dst16[bl][y][c]) =
        make_uint2((a0 & 0xffffu) | (a1 << 16), (a2 & 0xffffu) | (a3 << 16));
    dst8[bl][y][c / 4] = (a0 & 0xffu) | ((a1 & 0xffu) << 8) |
                         ((a2 & 0xffu) << 16) | (a3 << 24);
    if (sq) atomicAdd(&sq[bl], a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3);
  }
}

template <int N, int NB, int G>
__global__ void __launch_bounds__(Tile<N, NB, G>::kThreads)
refine_tile_kernel(const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ regions, int B,
                   float* __restrict__ ssd_out,
                   int32_t* __restrict__ disp_out) {
  using T = Tile<N, NB, G>;
  constexpr int R = T::R;
  __shared__ typename T::Smem sm;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * NB;
  const int nb = min(NB, B - b0);

  for (int i = tid; i < NB * kK; i += blockDim.x) (&sm.cross[0][0])[i] = 0;
  if (tid < NB) sm.bsq[tid] = 0;
  __syncthreads();
  bool ok10 = true, ok8 = true;
  stage<R, T::RP16, T::RPW, NB>(regions + (size_t)b0 * R * R, nb, sm.reg16,
                                sm.reg8, nullptr, ok10, ok8);
  stage<N, T::BP16, T::BPW, NB>(blocks + (size_t)b0 * N * N, nb, sm.blk16,
                                sm.blk8, sm.bsq, ok10, ok8);
  ok10 = __syncthreads_and(ok10);
  ok8 = __syncthreads_and(ok8);

  if (!ok10) {  // a value outside [0, 1023]: the direct path, block by block
    for (int bl = 0; bl < nb; ++bl) {
      const int b = b0 + bl;
      unsigned long long key = direct_min_key(
          blocks + (size_t)b * N * N, regions + (size_t)b * R * R, N,
          kRadius, tid, blockDim.x);
      key = cta_min(key, sm.scratch);
      if (tid == 0) write_result(key, b, kRadius, ssd_out, disp_out);
    }
    return;
  }

  // window sums of r^2: sliding row sums, then sliding column sums
  if (tid < nb * R) {
    const int bl = tid / R, y = tid - bl * R;
    int32_t sq[R];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const uint2 v = *reinterpret_cast<const uint2*>(&sm.reg16[bl][y][4 * q]);
      const int32_t v0 = v.x & 0xffff, v1 = v.x >> 16, v2 = v.y & 0xffff,
                    v3 = v.y >> 16;
      sq[4 * q] = v0 * v0;
      sq[4 * q + 1] = v1 * v1;
      sq[4 * q + 2] = v2 * v2;
      sq[4 * q + 3] = v3 * v3;
    }
    int32_t s = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) s += sq[j];
    sm.rowsq[bl][y][0] = s;
#pragma unroll
    for (int dx = 1; dx < kS; ++dx) {
      s += sq[dx + N - 1] - sq[dx - 1];
      sm.rowsq[bl][y][dx] = s;
    }
  }
  __syncthreads();
  if (tid < nb * kS) {
    const int bl = tid / kS, dx = tid - bl * kS;
    int32_t s = 0;
#pragma unroll 8
    for (int i = 0; i < N; ++i) s += sm.rowsq[bl][i][dx];
    sm.win[bl][dx] = s;
#pragma unroll
    for (int dy = 1; dy < kS; ++dy) {
      s += sm.rowsq[bl][dy + N - 1][dx] - sm.rowsq[bl][dy - 1][dx];
      sm.win[bl][dy * kS + dx] = s;
    }
  }

  // cross term sum r * b: thread (bl, g, dy) owns rows g, g + G, ... and
  // all 17 dx
  if (tid < nb * kS * G) {
    const int bl = tid / (kS * G);
    const int rem = tid - bl * kS * G;
    const int g = rem / kS;
    const int dy = rem - g * kS;
    uint32_t acc[kS];
#pragma unroll
    for (int dx = 0; dx < kS; ++dx) acc[dx] = 0;
    if (ok8) {
      for (int m = 0; m < N / G; ++m) {
        const int i = g + G * m;
        const uint32_t* rr = sm.reg8[bl][dy + i];
        const uint32_t* br = sm.blk8[bl][i];
        uint32_t w[R / 4];
#pragma unroll
        for (int q = 0; q < R / 4; ++q) w[q] = rr[q];
#pragma unroll
        for (int jq = 0; jq < N / 4; ++jq) {
          const uint32_t bw = br[jq];
#pragma unroll
          for (int dx = 0; dx < kS; ++dx) {
            const int q = jq + dx / 4, s = dx % 4;
            // the 4 region bytes at byte offset 4 * q + s
            const uint32_t rw =
                s == 0 ? w[q] : __byte_perm(w[q], w[q + 1], 0x3210 + 0x1111 * s);
            acc[dx] = __dp4a(rw, bw, acc[dx]);
          }
        }
      }
    } else {
      for (int m = 0; m < N / G; ++m) {
        const int i = g + G * m;
        const uint16_t* rr = sm.reg16[bl][dy + i];
        const uint16_t* br = sm.blk16[bl][i];
        uint32_t r[R];
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const uint2 v = *reinterpret_cast<const uint2*>(rr + 4 * q);
          r[4 * q] = v.x & 0xffffu;
          r[4 * q + 1] = v.x >> 16;
          r[4 * q + 2] = v.y & 0xffffu;
          r[4 * q + 3] = v.y >> 16;
        }
#pragma unroll
        for (int jq = 0; jq < N / 4; ++jq) {
          const uint2 v = *reinterpret_cast<const uint2*>(br + 4 * jq);
          const uint32_t bv[4] = {v.x & 0xffffu, v.x >> 16, v.y & 0xffffu,
                                  v.y >> 16};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int dx = 0; dx < kS; ++dx)
              acc[dx] += r[4 * jq + u + dx] * bv[u];
        }
      }
    }
#pragma unroll
    for (int dx = 0; dx < kS; ++dx)
      atomicAdd(reinterpret_cast<uint32_t*>(&sm.cross[bl][dy * kS + dx]),
                acc[dx]);
  }
  __syncthreads();

  // one warp per block: SSD = win - 2 * cross + bsq in 64-bit, then argmin
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < nb) {
    const long long bsq = sm.bsq[warp];
    unsigned long long key = ~0ull;
    for (int k = lane; k < kK; k += 32) {
      const long long ssd = (long long)sm.win[warp][k] + bsq -
                            2LL * (long long)sm.cross[warp][k];
      key = kmin(key, make_key((int32_t)ssd, k));
    }
    key = warp_min(key);
    if (lane == 0) write_result(key, b0 + warp, kRadius, ssd_out, disp_out);
  }
}

template <int N, int NB, int G>
int launch_tile(const void* blocks, const void* regions, int B, void* ssd,
                void* disp, cudaStream_t stream) {
  using T = Tile<N, NB, G>;
  refine_tile_kernel<N, NB, G><<<(B + NB - 1) / NB, T::kThreads, 0, stream>>>(
      (const int32_t*)blocks, (const int32_t*)regions, B, (float*)ssd,
      (int32_t*)disp);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks (B, n, n) int32, regions (B, n+2r, n+2r) int32 -> ssd (B,)
// float32 and disp (B, 2) int32.  Returns cudaGetLastError().
extern "C" int av1_refine_ssd(const void* blocks, const void* regions,
                              int B, int n, int radius, void* ssd,
                              void* disp, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // the tile kernel reads both inputs as 16-byte vectors
  const bool aligned =
      (((uintptr_t)blocks | (uintptr_t)regions) & 15) == 0;
  if (aligned && radius == kRadius && n == 32)
    return launch_tile<32, 1, 8>(blocks, regions, B, ssd, disp, s);
  if (aligned && radius == kRadius && n == 16)
    return launch_tile<16, 4, 4>(blocks, regions, B, ssd, disp, s);
  refine_direct_kernel<<<B, kDirectThreads, 0, s>>>(
      (const int32_t*)blocks, (const int32_t*)regions, n, radius,
      (float*)ssd, (int32_t*)disp);
  return (int)cudaGetLastError();
}
