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
// the image (173 KB; 346 KB as the forward's fixed-point sums) lives in
// L2. The contrast-maximization ascent calls the pair 81 + 40 times per
// window, so what is scarce is launches and the host's time per launch.
// The design therefore removes launches and bytes around the kernels rather
// than cycles inside them:
// - the C entry zeroes the forward's accumulator itself (cudaMemsetAsync on
//   the caller's stream) and converts it, so one splat is one call from
//   Python;
// - the SE2 instantiation reads the unwarped (x, y), the event time t and
//   (omega, vx, vy) from device memory and warps in registers, so the warped
//   coordinates, the weight product and their copies never reach memory;
//   a validity mask (bool) is read as it is and becomes the weight here;
// - the VJP gathers each event's <= 36 taps of G (read-only path, L1/L2)
//   instead of rebuilding the dense matrices, and in the SE2 form chains
//   them to d/d(omega, vx, vy) and reduces them on the card: warp shuffles,
//   shared memory, one partial per block, then a second kernel adds the
//   partials in a fixed order, so the gradient is the same bits every run;
// - the forward adds each tap into a 64-bit fixed-point accumulator with an
//   integer atomic (the f32 product rounded to a multiple of 2^-32), and a
//   second kernel converts the accumulator to f32. Integer addition is
//   associative, so the image is the same bits every run whatever order the
//   atomics land in. With f32 atomics it was not, and the 40-step
//   contrast-maximization ascent carried that last-bit noise into the SE2
//   parameters, where it moved a warped event across a truncation edge
//   (a tap of ~1.4e-3 of the image's maximum appearing or not from run to
//   run). The rounding to 2^-32 is far below the f32 rounding of the plain
//   version's sums (one ulp is 9.5e-7 at 10). The range: a weight of
//   magnitude 2^16 or more is out of range and, like a non-finite one,
//   makes every pixel NaN; a pixel's sum of |taps| must stay under 2^31.
//
// A per-block copy of the image in shared memory was reckoned and not
// built: 180 x 240 f32 = 173 KB allows one block per SM, and each block
// must flush 43,200 pixels with global atomics at its end. That beats the
// 36 N scalar atomics of the direct form only with fewer than 36 N / 43,200
// blocks: 13 at N = 16,384 and 54 at N = 65,536, i.e. with most of the 132
// SMs idle. Events arrive in time order, not by row, so a row band per
// block would need a sort per ascent step. The direct form's measured
// device time (4.6 us forward with f32 atomics and 5.6 us VJP at
// N = 16,384, H100 80GB HBM3 at 700 W) is under the host's cost of one
// launch, so such a copy has nothing to win.
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
//   (in the separable form 0 * NaN poisons a whole row and column), through
//   a flag that the conversion kernel reads;
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
constexpr float kFixScale = 4294967296.0f;     // 2^32: fixed-point units per 1.0
constexpr double kFixUnit = 1.0 / 4294967296.0;
constexpr float kMaxWeight = 65536.0f;         // 2^16

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

// One thread per event: its taps into acc (H*W fixed-point sums); a NaN
// coordinate or a weight out of range sets *poison instead.
template <bool kSe2>
__global__ void __launch_bounds__(kThreads)
splat_fwd_kernel(Events ev, unsigned long long* __restrict__ acc,
                 unsigned long long* __restrict__ poison, int n, int H, int W,
                 float inv2s2, float trunc, int ntap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Coords co = load_coords<kSe2>(ev, i);
  const float x = co.x, y = co.y;
  const float w = load_weight(ev, i);

  if (isnan(x) || isnan(y) || !(fabsf(w) < kMaxWeight)) {
    *poison = 1ull;
    return;
  }
  if (w == 0.0f || !near_image(x, y, H, W, trunc)) return;

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
    unsigned long long* row = acc + (ptrdiff_t)h * W + c0;
#pragma unroll
    for (int b = 0; b < kMaxTap; ++b) {
      if (gx[b] != 0.0f) {
        atomicAdd(row + b, (unsigned long long)__float2ll_rn(gy * gx[b] * kFixScale));
      }
    }
  }
}

// One thread per pixel: the fixed-point sum as f32, or NaN if poisoned.
__global__ void __launch_bounds__(kThreads)
splat_fwd_finish_kernel(const long long* __restrict__ acc,
                        const unsigned long long* __restrict__ poison,
                        float* __restrict__ out, int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  out[i] = *poison ? NAN : (float)((double)acc[i] * kFixUnit);
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

}  // namespace

// Threads per block of both kernels: the SE2 VJP needs (ceil(n / it), 3)
// floats of scratch.
extern "C" int splat_threads() { return kThreads; }

// out (H, W) f32 is written; scratch holds H * W + 1 64-bit words (the
// fixed-point image and the poison flag) and is zeroed here. t == nullptr:
// the events' own coordinates; else the SE2 warp with params (device) and
// the centre (cx, cy). w is (n,) f32, or a (n,) bool mask if w_is_mask.
extern "C" int splat_gauss_forward(const void* xy, const void* t, const void* w,
                                   int w_is_mask, const void* params, float cx,
                                   float cy, void* out, void* scratch, int n, int H,
                                   int W, float inv2s2, float trunc, int ntap,
                                   void* stream) {
  if (ntap < 1 || ntap > kMaxTap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hw = H * W;
  unsigned long long* acc = (unsigned long long*)scratch;
  cudaError_t rc = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * ((size_t)hw + 1), s);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) {
    const Events ev{(const float*)xy, (const float*)t, w, w_is_mask,
                    (const float*)params, cx, cy};
    const int blocks = (n + kThreads - 1) / kThreads;
    if (t != nullptr) {
      splat_fwd_kernel<true><<<blocks, kThreads, 0, s>>>(ev, acc, acc + hw, n, H, W,
                                                         inv2s2, trunc, ntap);
    } else {
      splat_fwd_kernel<false><<<blocks, kThreads, 0, s>>>(ev, acc, acc + hw, n, H, W,
                                                          inv2s2, trunc, ntap);
    }
  }
  splat_fwd_finish_kernel<<<(hw + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const long long*)acc, acc + hw, (float*)out, hw);
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
