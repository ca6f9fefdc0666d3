// K2: all-displacement SSD refine with first-minimum argmin.
//
// Replaces the Pallas kernel av1tpu/encoder/kernels/pallas_motion.py
// (_refine_kernel, launched by refine_ssd): for each n x n source block,
// the SSD against every displacement (dy, dx) in [-r, r]^2 of its
// (n + 2r)^2 search region, and the displacement of the first strict
// minimum in dy-major order k = (dy + r) * (2r + 1) + (dx + r).
//
// Bound on the H100: integer ALU (289 * n^2 multiply-adds per block at
// r = 8) fed from shared memory; device-memory reads are one region and
// one block per CTA.  Design: one CTA per block.  The region and block
// are staged into shared memory once; thread k evaluates displacement k
// over the whole block with int32 sums (exact: an 8- or 10-bit 32x32
// SSD is at most 1024 * 1023^2 < 2^31).  The CTA argmin packs
// (ssd, k) into one 64-bit key, so a min-reduction over keys breaks
// ties toward the lowest k -- the reference's strict '<' in k order.
// The TPU version's block-index-last layout and 128-lane batch padding
// are layout workarounds and are not carried over: inputs are
// block-first, blocks (B, n, n) and regions (B, R, R), int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 320;  // >= 289 displacements, whole warps

__global__ void refine_ssd_kernel(const int32_t* __restrict__ blocks,
                                  const int32_t* __restrict__ regions,
                                  int n, int radius,
                                  float* __restrict__ ssd_out,
                                  int32_t* __restrict__ disp_out) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int S = 2 * radius + 1;
  const int K = S * S;
  const int R = n + 2 * radius;
  int32_t* reg = smem;          // R * R
  int32_t* blk = smem + R * R;  // n * n
  const int32_t* rsrc = regions + (size_t)b * R * R;
  const int32_t* bsrc = blocks + (size_t)b * n * n;
  for (int i = threadIdx.x; i < R * R; i += blockDim.x) reg[i] = rsrc[i];
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) blk[i] = bsrc[i];
  __syncthreads();

  unsigned long long key = ~0ull;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int dy = k / S;
    const int dx = k - dy * S;
    int32_t acc = 0;
    for (int i = 0; i < n; ++i) {
      const int32_t* rrow = reg + (dy + i) * R + dx;
      const int32_t* brow = blk + i * n;
      for (int j = 0; j < n; ++j) {
        const int32_t d = rrow[j] - brow[j];
        acc += d * d;
      }
    }
    const unsigned long long kk =
        ((unsigned long long)(uint32_t)acc << 32) | (uint32_t)k;
    key = kk < key ? kk : key;
  }

  // warp min, then one key per warp through shared memory
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = o < key ? o : key;
  }
  __shared__ unsigned long long warp_keys[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_keys[warp] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long best = warp_keys[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      best = warp_keys[w] < best ? warp_keys[w] : best;
    const int kbest = (int)(best & 0xffffffffu);
    ssd_out[b] = (float)(uint32_t)(best >> 32);
    disp_out[2 * b] = kbest / S - radius;
    disp_out[2 * b + 1] = kbest % S - radius;
  }
}

}  // namespace

// blocks (B, n, n) int32, regions (B, n+2r, n+2r) int32 -> ssd (B,)
// float32 and disp (B, 2) int32.  Returns cudaGetLastError().
extern "C" int av1_refine_ssd(const void* blocks, const void* regions,
                              int B, int n, int radius, void* ssd,
                              void* disp, void* stream) {
  if (B <= 0) return 0;
  const int R = n + 2 * radius;
  const size_t smem = (size_t)(R * R + n * n) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  refine_ssd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)blocks, (const int32_t*)regions, n, radius,
      (float*)ssd, (int32_t*)disp);
  return (int)cudaGetLastError();
}
