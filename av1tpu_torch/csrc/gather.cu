// K1: per-block window gather, one kernel behind every entry.
//
// Replaces the Pallas kernel av1tpu/encoder/kernels/pallas_gather.py
// (_gather_kernel, launched by _gather_tpu and reached through
// gather_windows, make_wide2 / gather_windows_wide and
// gather_windows_ref2): for B blocks, copy the (W, W) window at the
// per-block origin (oy[b], ox[b]) out of a padded 2-D plane.  The TPU
// version DMAs an (8, 128)-aligned covering region and extracts the
// window with two one-hot matmuls, and its two-plane forms copy both
// planes side by side into one float32 plane per frame; all of that
// exists for Mosaic's tiling rules and is not carried over.
//
// What it computes, for output plane j < P (P = 1 or 2) and block b:
//   out[j, b] = plane[j + P * (ri[b] > 0)] [y0 .. y0+W, x0 .. x0+W]
// with y0, x0 clamped into the plane like jax.lax.dynamic_slice and
// ri absent (null) for the one-plane entries.  The base pointers are
// passed by value, so U and V (P = 2), and with a selector their LAST
// and GOLDEN planes (LAST_U, LAST_V, GOLDEN_U, GOLDEN_V), go in one
// launch with no copy of any plane.  Planes are int16 or int32; the
// output is (P, B, W, W) int32, bit-identical to the plane values.
//
// Bound on the H100: bytes.  No arithmetic; the output (4 bytes a
// pixel, (P B W^2) of them) is most of the traffic, since neighbouring
// windows overlap and their reads mostly hit L2.  The design:
// - G consecutive windows of one output plane per CTA (G chosen per W
//   so that a group writes ~64 KB and starts on a 32-byte sector, fewer
//   where that would leave under 1.5 groups an SM).  The group's output
//   is one contiguous run of G W^2 int32 with no gap between windows,
//   so the CTA writes it with aligned 16-byte (int4) stores; only where
//   a run does not start on 16 bytes (the ragged last group, a plane
//   of B W^2 not a multiple of 4) a few scalars go before and after.
// - The stores are streaming (st.global.cs, evict-first): at 1080p a
//   launch writes 15-33 MB beside 10-20 MB of planes in a 50 MB L2, and
//   write-back stores evict the planes that the next windows re-read.
// - The group's origins and selectors are read once, by G threads,
//   into shared memory as row pointers; the copy loop reads none.
// - Compile-time W for the main-path widths {15, 23, 25, 32, 41, 48}:
//   the divisions that map an output index to (window, row, column)
//   become multiplies and shifts.  Any other W runs the same code with
//   a multiply-shift divider computed on the host (no hardware
//   division per element either way).
// - A grid of at most kCtasPerSm CTAs per SM strides over the groups
//   instead of one short-lived CTA per window.
// Reads stay direct loads through the read-only path.  What was
// measured, and what did not pay (write-back stores, smaller or larger
// groups, fewer CTAs an SM, loading the next group's origins ahead), is
// in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 64;    // windows per CTA at most
constexpr int kCtasPerSm = 8;    // 2048 resident threads an SM
constexpr int kGroupBytes = 65536;

// n / d as a multiply and a shift, for 0 <= n < 2^31 (Granlund and
// Montgomery): l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1.
struct Divider {
  uint32_t d, m, l;
};

Divider make_divider(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return {d, (uint32_t)m, l};
}

// Index maps of a window of side W: compile-time for WC > 0, else the
// runtime side with its two dividers.
template <int WC>
struct Side {
  __host__ __device__ Side(const Divider&, const Divider&) {}
  __device__ uint32_t w() const { return WC; }
  __device__ uint32_t div_w(uint32_t i) const { return i / WC; }
  __device__ uint32_t div_ww(uint32_t i) const { return i / (WC * WC); }
};

template <>
struct Side<0> {
  Divider dw, dww;
  __host__ __device__ Side(const Divider& a, const Divider& b)
      : dw(a), dww(b) {}
  __device__ uint32_t w() const { return dw.d; }
  __device__ static uint32_t div(uint32_t n, const Divider& v) {
    return (__umulhi(n, v.m) + n) >> v.l;
  }
  __device__ uint32_t div_w(uint32_t i) const { return div(i, dw); }
  __device__ uint32_t div_ww(uint32_t i) const { return div(i, dww); }
};

struct Planes {
  const void* p[4];
};

template <typename T, int WC>
__global__ void __launch_bounds__(kThreads)
gather_kernel(Planes planes, int P, int hp, int wp,
              const int32_t* __restrict__ ri,
              const int32_t* __restrict__ oy,
              const int32_t* __restrict__ ox, int B, Divider dw,
              Divider dww, int G, int32_t* __restrict__ out) {
  const Side<WC> side(dw, dww);
  const uint32_t W = side.w();
  const uint32_t WW = W * W;
  __shared__ const T* rows[kMaxGroup];
  const int per_plane = (B + G - 1) / G;
  for (int grp = blockIdx.x; grp < P * per_plane; grp += gridDim.x) {
    const int j = grp / per_plane;
    const int b0 = (grp - j * per_plane) * G;
    const int nb = min(G, B - b0);
    __syncthreads();                    // the last group's readers are done
    if ((int)threadIdx.x < nb) {
      const int b = b0 + threadIdx.x;
      const int sel = (ri != nullptr && ri[b] > 0) ? 1 : 0;
      const int y0 = min(max(oy[b], 0), hp - (int)W);
      const int x0 = min(max(ox[b], 0), wp - (int)W);
      rows[threadIdx.x] = static_cast<const T*>(planes.p[j + P * sel]) +
                          (size_t)y0 * wp + x0;
    }
    __syncthreads();
    const size_t start = ((size_t)j * B + b0) * WW;
    int32_t* dst = out + start;
    const uint32_t n = nb * WW;
    const uint32_t head = min((uint32_t)((4 - (start & 3)) & 3), n);
    const uint32_t nvec = (n - head) >> 2;
    const uint32_t tail = head + 4 * nvec;

    // the 16-byte body: vector v holds elements head + 4v .. head + 4v + 3
    int4* body = reinterpret_cast<int4*>(dst + head);
    for (uint32_t v = threadIdx.x; v < nvec; v += kThreads) {
      const uint32_t i = head + 4 * v;
      uint32_t k = side.div_ww(i);
      const uint32_t rem = i - k * WW;
      uint32_t r = side.div_w(rem);
      uint32_t c = rem - r * W;
      const T* row = rows[k] + (size_t)r * wp;
      int32_t e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        e[q] = (int32_t)__ldg(row + c);
        if (++c == W) {                 // next row, or the next window
          c = 0;
          if (++r == W) {
            r = 0;
            if (q < 3) row = rows[++k];
          } else {
            row += wp;
          }
        }
      }
      __stcs(body + v, make_int4(e[0], e[1], e[2], e[3]));
    }
    // at most three scalars before the body and three after it
    const uint32_t t = threadIdx.x;
    if (t < 6) {
      const uint32_t i = t < 3 ? t : tail + (t - 3);
      if ((t < 3 && i < head) || (t >= 3 && i < n)) {
        const uint32_t k = side.div_ww(i);
        const uint32_t rem = i - k * WW;
        const uint32_t r = side.div_w(rem);
        dst[i] = (int32_t)__ldg(rows[k] + (size_t)r * wp + (rem - r * W));
      }
    }
  }
}

// The SM count of the current card (the wrapper makes the planes' card
// current), kept per card: a process may launch on several.
int sm_count() {
  constexpr int kCards = 64;
  static int counts[kCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kCards && counts[dev] > 0) return counts[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 1;
  if (dev >= 0 && dev < kCards) counts[dev] = n;
  return n;
}

// Windows per CTA: about kGroupBytes of output in a multiple of the
// step that starts every group on a 32-byte sector (8 windows for odd
// W), halved while that leaves fewer than 1.5 groups an SM, down to the
// step that keeps 16-byte alignment (4 for odd W).
int windows_per(int ww, int bytes) {   // least g with 4 g ww % bytes == 0
  int g = 1;
  while ((4 * g * ww) % bytes) ++g;
  return g;
}

int default_group(int W, int B, int P) {
  const int ww = W * W;
  const int sector = windows_per(ww, 32), vec = windows_per(ww, 16);
  int g = kGroupBytes / 4 / ww;
  if (g > kMaxGroup) g = kMaxGroup;
  g = g < sector ? sector : g / sector * sector;
  while (g > vec && 2 * P * ((B + g - 1) / g) < 3 * sm_count()) {
    const int h = g / 2;
    g = h >= sector ? h / sector * sector : (h + vec - 1) / vec * vec;
  }
  return g;
}

template <typename T>
cudaError_t launch_t(const Planes& pl, int P, int hp, int wp,
                     const int32_t* ri, const int32_t* oy, const int32_t* ox,
                     int B, int W, int32_t* out, cudaStream_t s) {
  const int G = default_group(W, B, P);
  const int groups = P * ((B + G - 1) / G);
  const int ctas = std::min(groups, sm_count() * kCtasPerSm);
  const Divider dw = make_divider(W), dww = make_divider(W * W);
#define AV1_K1(WC)                                                         \
  gather_kernel<T, WC><<<ctas, kThreads, 0, s>>>(pl, P, hp, wp, ri, oy, ox, \
                                                 B, dw, dww, G, out)
  switch (W) {
    case 15: AV1_K1(15); break;
    case 23: AV1_K1(23); break;
    case 25: AV1_K1(25); break;
    case 32: AV1_K1(32); break;
    case 41: AV1_K1(41); break;
    case 48: AV1_K1(48); break;
    default: AV1_K1(0); break;
  }
#undef AV1_K1
  return cudaGetLastError();
}

}  // namespace

// Windows of P (1 or 2) planes of one shape and dtype (0 = int16,
// 1 = int32) into out (P, B, W, W) int32.  ri null: output plane j
// reads p[j].  ri given: it reads p[j + P * (ri[b] > 0)], so the planes
// are (LAST_0 .. LAST_{P-1}, GOLDEN_0 .. GOLDEN_{P-1}).  Returns
// cudaGetLastError().
extern "C" int av1_gather_windows(const void* p0, const void* p1,
                                  const void* p2, const void* p3, int P,
                                  int dtype, int hp, int wp, const void* ri,
                                  const void* oy, const void* ox, int B,
                                  int W, void* out, void* stream) {
  if (B <= 0) return 0;
  if (P < 1 || P > 2 || W < 1 || W > hp || W > wp) {
    return (int)cudaErrorInvalidValue;
  }
  const Planes pl{{p0, p1, p2, p3}};
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* r = (const int32_t*)ri;
  const int32_t* y = (const int32_t*)oy;
  const int32_t* x = (const int32_t*)ox;
  int32_t* o = (int32_t*)out;
  const cudaError_t err =
      dtype == 0
          ? launch_t<int16_t>(pl, P, hp, wp, r, y, x, B, W, o, s)
          : launch_t<int32_t>(pl, P, hp, wp, r, y, x, B, W, o, s);
  return (int)err;
}
