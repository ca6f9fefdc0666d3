// K1: per-block window gather.
//
// Replaces the Pallas kernel av1tpu/encoder/kernels/pallas_gather.py
// (_gather_kernel, launched by _gather_tpu): for B blocks, copy the
// (W, W) window at per-block origins (oy[b], ox[b]) out of a padded 2-D
// plane.  The TPU version DMAs an (8, 128)-aligned covering region and
// extracts the window with two one-hot matmuls; both steps exist only
// because of Mosaic's tiling rules and are not carried over.
//
// Bound on the H100: bytes.  B * W^2 reads and writes, no arithmetic.
// Design: one CTA per block; consecutive threads take consecutive
// pixels of a window row, so reads of the plane and writes of the
// output are coalesced along x.  The origin is clamped to the plane
// like jax.lax.dynamic_slice (callers pass clamped origins already; the
// clamp keeps a bad origin from reading out of bounds).
//
// Planes are int16 or int32; output is int32, bit-identical to the
// input values.
//
// Two-plane entry (av1_gather_windows2): block b reads its window from
// plane ri[b] of a (LAST, GOLDEN) pair.  It replaces the same Pallas
// kernel reached through make_wide2 / gather_windows_wide /
// gather_windows_ref2, which copy both planes side by side into one
// 128-column-padded float32 plane per frame and add ri * offset to the
// column origin so that the Mosaic kernel stays 2-D.  Here the kernel
// takes the two base pointers and each CTA picks its own: no copy of
// the planes is made.  ri is clamped to {0, 1}, so a bad selector
// cannot read out of bounds.  Bound: bytes, as above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void gather_windows_kernel(const T* __restrict__ plane, int hp,
                                      int wp,
                                      const int32_t* __restrict__ oy,
                                      const int32_t* __restrict__ ox,
                                      int W, int32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int y0 = min(max(oy[b], 0), hp - W);
  const int x0 = min(max(ox[b], 0), wp - W);
  const int ww = W * W;
  int32_t* dst = out + (size_t)b * ww;
  for (int i = threadIdx.x; i < ww; i += blockDim.x) {
    const int r = i / W;
    const int c = i - r * W;
    dst[i] = (int32_t)plane[(size_t)(y0 + r) * wp + (x0 + c)];
  }
}

template <typename T>
__global__ void gather_windows2_kernel(const T* __restrict__ plane0,
                                       const T* __restrict__ plane1, int hp,
                                       int wp,
                                       const int32_t* __restrict__ ri,
                                       const int32_t* __restrict__ oy,
                                       const int32_t* __restrict__ ox,
                                       int W, int32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const T* __restrict__ plane = ri[b] > 0 ? plane1 : plane0;
  const int y0 = min(max(oy[b], 0), hp - W);
  const int x0 = min(max(ox[b], 0), wp - W);
  const int ww = W * W;
  int32_t* dst = out + (size_t)b * ww;
  for (int i = threadIdx.x; i < ww; i += blockDim.x) {
    const int r = i / W;
    const int c = i - r * W;
    dst[i] = (int32_t)plane[(size_t)(y0 + r) * wp + (x0 + c)];
  }
}

}  // namespace

// dtype: 0 = int16 plane, 1 = int32 plane.  Returns cudaGetLastError().
extern "C" int av1_gather_windows(const void* plane, int dtype, int hp,
                                  int wp, const void* oy, const void* ox,
                                  int B, int W, void* out, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (dtype == 0) {
    gather_windows_kernel<int16_t><<<B, threads, 0, s>>>(
        (const int16_t*)plane, hp, wp, (const int32_t*)oy,
        (const int32_t*)ox, W, (int32_t*)out);
  } else {
    gather_windows_kernel<int32_t><<<B, threads, 0, s>>>(
        (const int32_t*)plane, hp, wp, (const int32_t*)oy,
        (const int32_t*)ox, W, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// Two planes of one shape and dtype; ri[b] selects plane0 (<= 0) or
// plane1 (> 0) per block.  Returns cudaGetLastError().
extern "C" int av1_gather_windows2(const void* plane0, const void* plane1,
                                   int dtype, int hp, int wp,
                                   const void* ri, const void* oy,
                                   const void* ox, int B, int W, void* out,
                                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (dtype == 0) {
    gather_windows2_kernel<int16_t><<<B, threads, 0, s>>>(
        (const int16_t*)plane0, (const int16_t*)plane1, hp, wp,
        (const int32_t*)ri, (const int32_t*)oy, (const int32_t*)ox, W,
        (int32_t*)out);
  } else {
    gather_windows2_kernel<int32_t><<<B, threads, 0, s>>>(
        (const int32_t*)plane0, (const int32_t*)plane1, hp, wp,
        (const int32_t*)ri, (const int32_t*)oy, (const int32_t*)ox, W,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
