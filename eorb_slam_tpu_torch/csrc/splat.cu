// Truncated separable Gaussian event splat, one thread per event, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel eorb_slam_tpu/ops/pallas_splat.py:_splat_kernel
// (launched by _splat_pallas). Both compute, for events (x_n, y_n, w_n),
//
//   img[h, c] = sum_n  w_n * gy(h - y_n) * gx(c - x_n),
//   g(d) = exp(-d^2 / (2 sigma^2)) * [|d| <= trunc]          (trunc = 2.5 px)
//
// The TPU kernel builds the dense (events x H) and (events x W) weight
// matrices in VMEM and contracts them on the matrix unit, because a TPU has
// no fast scatter. Here the work is sparse instead: an event touches at most
// (2*trunc+1)^2 = 36 pixels, so each thread evaluates its <= 6 row and
// <= 6 column weights with expf (the same formula, term for term, as
// event/tensorize.py:_splat_gauss_separable) and atomically adds their
// products into the (H, W) f32 image.
//
// What bounds it on the card: the f32 atomics into the output, and the
// output's memory traffic (180x240x4 B = 173 KB, which sits in L2; each
// event adds <= 36 atomics to it). Events that land on the same pixels
// serialise in L2's atomic units. The design does the least that is right:
// no dense work, one pass over the events (16 B read per event), and no
// pixel is touched by an event whose weight there is 0. A per-block copy of
// the image in shared memory (173 KB fits in 227 KB) would move the
// atomics out of L2; that is later work.
//
// Semantics that must match the plain separable version exactly:
// - taps are tested with the same f32 arithmetic: dy = (float)h - y and
//   |dy| <= trunc, for every integer h in floor(y - trunc) .. +ntap-1;
// - events with a finite coordinate far outside the image, +-inf
//   coordinates, or weight 0 add nothing;
// - a NaN coordinate or a non-finite weight makes every pixel NaN (in the
//   separable form 0 * NaN poisons a whole row and column of the product).
//
// Plain C interface for ctypes: the wrapper (ops/hopper_splat.py) zeroes the
// output, passes device pointers and the stream, and raises if the returned
// cudaGetLastError() code is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTap = 16;
constexpr int kThreads = 256;

__global__ void splat_gauss_kernel(const float* __restrict__ xy,
                                   const float* __restrict__ w_ev,
                                   float* __restrict__ out,
                                   int n, int H, int W,
                                   float inv2s2, float trunc, int ntap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = xy[2 * i];
  const float y = xy[2 * i + 1];
  const float w = w_ev[i];

  if (isnan(x) || isnan(y) || !isfinite(w)) {
    for (int k = 0; k < H * W; ++k) out[k] = NAN;
    return;
  }
  if (w == 0.0f) return;
  // also rejects +-inf and coordinates too large for an int
  if (!(x > -trunc - 1.0f && x < W + trunc + 1.0f &&
        y > -trunc - 1.0f && y < H + trunc + 1.0f)) {
    return;
  }

  const int h0 = (int)floorf(y - trunc);
  const int c0 = (int)floorf(x - trunc);

  float gx[kMaxTap];
#pragma unroll
  for (int b = 0; b < kMaxTap; ++b) {
    gx[b] = 0.0f;
    if (b < ntap) {
      const int c = c0 + b;
      const float dx = (float)c - x;
      if (c >= 0 && c < W && fabsf(dx) <= trunc) gx[b] = expf(-dx * dx * inv2s2);
    }
  }

  for (int a = 0; a < ntap; ++a) {
    const int h = h0 + a;
    if (h < 0 || h >= H) continue;
    const float dy = (float)h - y;
    if (!(fabsf(dy) <= trunc)) continue;
    const float gy = expf(-dy * dy * inv2s2) * w;
    const int row = h * W + c0;
#pragma unroll
    for (int b = 0; b < kMaxTap; ++b) {
      // gx[b] is 0 exactly where the tap is outside the image or window
      if (b < ntap && gx[b] != 0.0f) atomicAdd(out + row + b, gy * gx[b]);
    }
  }
}

}  // namespace

extern "C" int splat_gauss_forward(const void* xy, const void* w_ev, void* out,
                                   int n, int H, int W, float inv2s2,
                                   float trunc, int ntap, void* stream) {
  if (ntap < 1 || ntap > kMaxTap) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    splat_gauss_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)xy, (const float*)w_ev, (float*)out, n, H, W, inv2s2,
        trunc, ntap);
  }
  return (int)cudaGetLastError();
}
