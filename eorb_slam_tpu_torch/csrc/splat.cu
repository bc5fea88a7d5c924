// Truncated separable Gaussian event splat for Hopper (sm_90a): the forward
// scatter and its vector-Jacobian product as a gather, each with the SE2 flow
// warp optionally computed in registers.
//
// Replaces the TPU kernel eorb_slam_tpu/ops/pallas_splat.py:_splat_kernel
// (launched by _splat_pallas) and, with splat_gauss_vjp, the dense autodiff
// that pallas_splat._splat_bwd ran in its place. For events (x_n, y_n, w_n)
//
//   img[h, c] = sum_n  w_n * gy(h - y_n) * gx(c - x_n),
//   g(d) = exp(-d^2 / (2 sigma^2)) * [|d| <= trunc]          (trunc = 2.5 px)
//
// and for a cotangent G (H, W), with k_n[h, c] = gy(h - y_n) * gx(c - x_n),
//
//   dL/dw_n = sum_hc G k_n,     dL/dx_n = w_n * sum_hc G k_n (c - x_n) / sigma^2,
//                               dL/dy_n = w_n * sum_hc G k_n (h - y_n) / sigma^2
//
// (the truncation mask has zero derivative, as in autograd of the separable
// form). The TPU kernel builds dense (events x H) and (events x W) weight
// matrices and contracts them on the matrix unit, because a TPU has no fast
// scatter; its backward differentiates that dense form. On this card both
// directions are sparse: an event touches at most 6 x 6 pixels.
//
// What bounds them: nothing on the device. The bytes that must move are
// 12 N + 4 H W forward (369 KB at N = 16,384: 0.11 us at 3.35 TB/s) and
// 16 N + 4 H W + 12 for the SE2 VJP (0.17 us), below what any launch costs;
// the image (173 KB) lives in L2. The contrast-maximization ascent calls the
// pair 81 + 40 times per window, so what is scarce is launches and the
// host's time per launch. The design therefore removes launches and bytes
// around the kernels rather than cycles inside them:
// - the C entry zeroes the image itself (cudaMemsetAsync on the caller's
//   stream), so one splat is one call from Python;
// - the SE2 instantiation reads the unwarped (x, y), the event time t and
//   (omega, vx, vy) from device memory and warps in registers, so the warped
//   coordinates, the weight product and their copies never reach memory;
//   a validity mask (bool) is read as it is and becomes the weight here;
// - the VJP gathers each event's <= 36 taps of G (read-only path, L1/L2)
//   instead of rebuilding the dense matrices, and in the SE2 form chains
//   them to d/d(omega, vx, vy) and reduces them on the card: warp shuffles,
//   shared memory, one partial per block, then a second kernel adds the
//   partials in a fixed order, so the gradient is the same bits every run;
// - the forward adds one row of taps with vector atomics (red.global.add
//   .v4.f32, compute capability 9.x): the column window is aligned down to a
//   multiple of the vector width and lanes outside the window carry 0, so a
//   6-tap row costs 2-3 atomics instead of 6. The width (4, 2 or 1) is an
//   argument so that a run can time them against each other (chip_smoke.py;
//   on an H100 80GB HBM3 at 700 W the SE2 forward took 9.6 / 7.5 / 6.9 us
//   at N = 16,384 and 27.5 / 18.4 / 13.3 us at N = 65,536 with 1 / 2 / 4
//   lanes, memset included); it falls to a narrower one where W is not a
//   multiple of it or the image is not aligned.
//
// A per-block copy of the image in shared memory was reckoned and not
// built: 180 x 240 f32 = 173 KB allows one block per SM, and each block
// must flush 43,200 pixels with global atomics at its end. That beats the
// 36 N scalar atomics of the direct form only with fewer than 36 N / 43,200
// blocks: 13 at N = 16,384 and 54 at N = 65,536, i.e. with most of the 132
// SMs idle. Events arrive in time order, not by row, so a row band per
// block would need a sort per ascent step. The direct form's measured
// device time (4.6 us forward and 5.6 us VJP at N = 16,384, same card) is
// under the host's cost of one launch, so such a copy has nothing to win.
//
// Semantics that must match the plain versions (ops/hopper_splat.py):
// - taps are tested with the same f32 arithmetic as
//   event/tensorize.py:_splat_gauss_separable: d = (float)c - x and
//   |d| <= trunc, for every integer c near x;
// - the in-kernel warp is event/tensorize.py:warp_se2 term for term, each
//   product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn are
//   never contracted into an FMA) with the accurate cosf and sinf (no
//   --use_fast_math), so a warped coordinate equals the plain one bit for
//   bit and no tap at |d| = trunc flips between the two;
// - events far outside the image, +-inf coordinates or weight 0 add
//   nothing; a NaN coordinate or a non-finite weight makes every pixel NaN
//   (in the separable form 0 * NaN poisons a whole row and column);
// - the VJP writes NaN where the plain VJP is not finite: every output of
//   an event with a NaN coordinate, the x (y) derivative of an event whose
//   x (y) is +-inf, and both derivatives under a non-finite weight.
//
// Plain C interface for ctypes. The entries launch on the given stream,
// allocate nothing, never synchronise and read nothing back (they can be
// captured in a CUDA graph); outputs and scratch come from the wrapper,
// which raises if the returned cudaError is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTap = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Events {
  const float* xy;      // (n, 2)
  const float* t;       // (n,), SE2 only
  const void* w;        // (n,) f32 weights, or (n,) bool mask
  int w_is_mask;
  const float* params;  // (3,) omega, vx, vy on the device, SE2 only
  float cx, cy;         // rotation centre, SE2 only
};

struct Coords {
  float x, y;           // where the event lands
  float t, ca, sa, rx, ry;  // SE2 only: what the chain rule needs
};

__device__ __forceinline__ float load_weight(const Events& ev, int i) {
  return ev.w_is_mask ? (float)(((const uint8_t*)ev.w)[i] != 0)
                      : ((const float*)ev.w)[i];
}

template <bool kSe2>
__device__ __forceinline__ Coords load_coords(const Events& ev, int i) {
  const float2 p = ((const float2*)ev.xy)[i];
  Coords c{};
  if constexpr (!kSe2) {
    c.x = p.x;
    c.y = p.y;
    return c;
  }
  // event/tensorize.py:warp_se2, every product and sum rounded on its own
  c.t = ev.t[i];
  const float a = __fmul_rn(ev.params[0], c.t);
  c.ca = cosf(a);
  c.sa = sinf(a);
  c.rx = __fsub_rn(p.x, ev.cx);
  c.ry = __fsub_rn(p.y, ev.cy);
  // ca * rx - sa * ry + cx - vx * t  and  sa * rx + ca * ry + cy - vy * t
  c.x = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(c.ca, c.rx), __fmul_rn(c.sa, c.ry)), ev.cx),
                  __fmul_rn(ev.params[1], c.t));
  c.y = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.sa, c.rx), __fmul_rn(c.ca, c.ry)), ev.cy),
                  __fmul_rn(ev.params[2], c.t));
  return c;
}

// finite and near enough to the image to have a tap (also rejects +-inf,
// NaN and coordinates too large for an int)
__device__ __forceinline__ bool near_image(float x, float y, int H, int W, float trunc) {
  return x > -trunc - 1.0f && x < W + trunc + 1.0f &&
         y > -trunc - 1.0f && y < H + trunc + 1.0f;
}

// One thread per event. kVec: lanes per atomic; needs W % kVec == 0 and the
// image aligned to kVec floats, so that an aligned group of columns never
// leaves its row.
template <bool kSe2, int kVec>
__global__ void __launch_bounds__(kThreads)
splat_fwd_kernel(Events ev, float* __restrict__ out, int n, int H, int W,
                 float inv2s2, float trunc, int ntap) {
  constexpr int kCols = kMaxTap + kVec;   // a multiple of kVec
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Coords co = load_coords<kSe2>(ev, i);
  const float x = co.x, y = co.y;
  const float w = load_weight(ev, i);

  if (isnan(x) || isnan(y) || !isfinite(w)) {
    for (int k = 0; k < H * W; ++k) out[k] = NAN;
    return;
  }
  if (w == 0.0f || !near_image(x, y, H, W, trunc)) return;

  const int h0 = (int)floorf(y - trunc);
  const int c0 = (int)floorf(x - trunc);
  const int off = ((c0 % kVec) + kVec) % kVec;
  const int ca0 = c0 - off;                // aligned down; may be negative
  const int ncols = off + ntap;            // columns ca0 .. ca0 + ncols - 1

  // gx[b] is 0 exactly where column ca0 + b is outside the image or the
  // truncation window, so groups made only of such columns are skipped
  float gx[kCols];
#pragma unroll
  for (int b = 0; b < kCols; ++b) {
    gx[b] = 0.0f;
    if (b < ncols) {
      const int c = ca0 + b;
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
    float* row = out + (ptrdiff_t)h * W + ca0;
#pragma unroll
    for (int b = 0; b < kCols; b += kVec) {
      bool any = false;
#pragma unroll
      for (int l = 0; l < kVec; ++l) any |= gx[b + l] != 0.0f;
      if (!any) continue;
      if constexpr (kVec == 4) {
        atomicAdd((float4*)(row + b), make_float4(gy * gx[b], gy * gx[b + 1],
                                                  gy * gx[b + 2], gy * gx[b + 3]));
      } else if constexpr (kVec == 2) {
        atomicAdd((float2*)(row + b), make_float2(gy * gx[b], gy * gx[b + 1]));
      } else {
        atomicAdd(row + b, gy * gx[b]);
      }
    }
  }
}

// One thread per event: s = sum G k, sx = sum G k (c - x) / sigma^2,
// sy = sum G k (h - y) / sigma^2 over the event's taps of G.
__device__ __forceinline__ void gather_taps(const float* __restrict__ g, float x, float y,
                                            int H, int W, float inv2s2, float trunc,
                                            int ntap, float& s, float& sx, float& sy) {
  s = sx = sy = 0.0f;
  if (!near_image(x, y, H, W, trunc)) return;
  const int h0 = (int)floorf(y - trunc);
  const int c0 = (int)floorf(x - trunc);
  float gx[kMaxTap], dxs[kMaxTap];
#pragma unroll
  for (int b = 0; b < kMaxTap; ++b) {
    gx[b] = 0.0f;
    dxs[b] = 0.0f;
    if (b < ntap) {
      const int c = c0 + b;
      const float dx = (float)c - x;
      if (c >= 0 && c < W && fabsf(dx) <= trunc) {
        gx[b] = expf(-dx * dx * inv2s2);
        dxs[b] = dx;
      }
    }
  }
  for (int a = 0; a < ntap; ++a) {
    const int h = h0 + a;
    if (h < 0 || h >= H) continue;
    const float dy = (float)h - y;
    if (!(fabsf(dy) <= trunc)) continue;
    const float gy = expf(-dy * dy * inv2s2);
    const float* row = g + (ptrdiff_t)h * W + c0;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int b = 0; b < kMaxTap; ++b) {
      if (b < ntap && gx[b] != 0.0f) {
        const float gk = __ldg(row + b) * gx[b];
        r0 += gk;
        r1 += gk * dxs[b];
      }
    }
    s += gy * r0;
    sx += gy * r1;
    sy += gy * dy * r0;
  }
  sx *= 2.0f * inv2s2;
  sy *= 2.0f * inv2s2;
}

// Identity: g_xy (n, 2) and g_w (n,), each written only if its pointer is
// given. SE2: the block's sums of d/d(omega, vx, vy) into partials
// (gridDim.x, 3).
template <bool kSe2>
__global__ void __launch_bounds__(kThreads)
splat_vjp_kernel(const float* __restrict__ g, Events ev, float* __restrict__ g_xy,
                 float* __restrict__ g_w, float* __restrict__ partials, int n,
                 int H, int W, float inv2s2, float trunc, int ntap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (i < n) {
    const Coords co = load_coords<kSe2>(ev, i);
    const float x = co.x, y = co.y;
    const float w = load_weight(ev, i);
    float s, sx, sy;
    if (isnan(x) || isnan(y)) {
      s = sx = sy = NAN;
    } else {
      gather_taps(g, x, y, H, W, inv2s2, trunc, ntap, s, sx, sy);
      const bool bad_w = !isfinite(w);
      sx = (isinf(x) || bad_w) ? NAN : w * sx;
      sy = (isinf(y) || bad_w) ? NAN : w * sy;
    }
    if constexpr (kSe2) {
      // d(xw)/d(omega) = t (-sa rx - ca ry), d(yw)/d(omega) = t (ca rx - sa ry),
      // d(xw)/d(vx) = d(yw)/d(vy) = -t
      d0 = co.t * (sx * (-co.sa * co.rx - co.ca * co.ry) +
                   sy * (co.ca * co.rx - co.sa * co.ry));
      d1 = -co.t * sx;
      d2 = -co.t * sy;
    } else {
      if (g_xy != nullptr) ((float2*)g_xy)[i] = make_float2(sx, sy);
      if (g_w != nullptr) g_w[i] = s;
    }
  }
  if constexpr (kSe2) {
    __shared__ float red[kWarps][3];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      d0 += __shfl_down_sync(0xffffffffu, d0, m);
      d1 += __shfl_down_sync(0xffffffffu, d1, m);
      d2 += __shfl_down_sync(0xffffffffu, d2, m);
    }
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5][0] = d0;
      red[threadIdx.x >> 5][1] = d1;
      red[threadIdx.x >> 5][2] = d2;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) acc += red[k][threadIdx.x];
      partials[blockIdx.x * 3 + threadIdx.x] = acc;
    }
  }
}

// One block of three warps: warp k adds column k of partials (blocks, 3) in
// a fixed order into out[k].
__global__ void sum_partials_kernel(const float* __restrict__ partials, int blocks,
                                    float* __restrict__ out) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int b = lane; b < blocks; b += 32) acc += partials[b * 3 + k];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, m);
  if (lane == 0) out[k] = acc;
}

template <bool kSe2>
void launch_fwd(int vec, int blocks, cudaStream_t s, const Events& ev, float* out,
                int n, int H, int W, float inv2s2, float trunc, int ntap) {
  if (vec == 4) {
    splat_fwd_kernel<kSe2, 4><<<blocks, kThreads, 0, s>>>(ev, out, n, H, W, inv2s2, trunc, ntap);
  } else if (vec == 2) {
    splat_fwd_kernel<kSe2, 2><<<blocks, kThreads, 0, s>>>(ev, out, n, H, W, inv2s2, trunc, ntap);
  } else {
    splat_fwd_kernel<kSe2, 1><<<blocks, kThreads, 0, s>>>(ev, out, n, H, W, inv2s2, trunc, ntap);
  }
}

}  // namespace

// Threads per block of both kernels: the SE2 VJP needs (ceil(n / it), 3)
// floats of scratch.
extern "C" int splat_threads() { return kThreads; }

// out (H, W) f32 is zeroed here and then accumulated. t == nullptr: the
// events' own coordinates; else the SE2 warp with params (device) and the
// centre (cx, cy). w is (n,) f32, or a (n,) bool mask if w_is_mask. vec:
// lanes per atomic wanted (4, 2 or 1).
extern "C" int splat_gauss_forward(const void* xy, const void* t, const void* w,
                                   int w_is_mask, const void* params, float cx,
                                   float cy, void* out, int n, int H, int W,
                                   float inv2s2, float trunc, int ntap, int vec,
                                   void* stream) {
  if (ntap < 1 || ntap > kMaxTap || (vec != 1 && vec != 2 && vec != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)H * W, s);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) {
    while (vec > 1 && (W % vec != 0 || (uintptr_t)out % (sizeof(float) * vec) != 0)) vec >>= 1;
    const Events ev{(const float*)xy, (const float*)t, w, w_is_mask,
                    (const float*)params, cx, cy};
    const int blocks = (n + kThreads - 1) / kThreads;
    if (t != nullptr) {
      launch_fwd<true>(vec, blocks, s, ev, (float*)out, n, H, W, inv2s2, trunc, ntap);
    } else {
      launch_fwd<false>(vec, blocks, s, ev, (float*)out, n, H, W, inv2s2, trunc, ntap);
    }
  }
  return (int)cudaGetLastError();
}

// g (H, W) f32 is the cotangent. t == nullptr: writes g_xy (n, 2) and g_w
// (n,), each if its pointer is given. Else: writes g_params (3,) =
// d/d(omega, vx, vy), through partials ((n + splat_threads() - 1) /
// splat_threads(), 3) of scratch.
extern "C" int splat_gauss_vjp(const void* g, const void* xy, const void* t,
                               const void* w, int w_is_mask, const void* params,
                               float cx, float cy, void* g_xy, void* g_w,
                               void* partials, void* g_params, int n, int H, int W,
                               float inv2s2, float trunc, int ntap, void* stream) {
  if (ntap < 1 || ntap > kMaxTap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Events ev{(const float*)xy, (const float*)t, w, w_is_mask,
                  (const float*)params, cx, cy};
  const int blocks = (n + kThreads - 1) / kThreads;
  if (t != nullptr) {
    if (blocks > 0) {
      splat_vjp_kernel<true><<<blocks, kThreads, 0, s>>>(
          (const float*)g, ev, nullptr, nullptr, (float*)partials, n, H, W, inv2s2,
          trunc, ntap);
    }
    sum_partials_kernel<<<1, 96, 0, s>>>((const float*)partials, blocks,
                                         (float*)g_params);
  } else if (blocks > 0) {
    splat_vjp_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const float*)g, ev, (float*)g_xy, (float*)g_w, nullptr, n, H, W, inv2s2,
        trunc, ntap);
  }
  return (int)cudaGetLastError();
}
