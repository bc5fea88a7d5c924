// Truncated separable Gaussian event splat for Hopper (sm_90a): the forward
// scatter and its vector-Jacobian product as a gather, each with the SE2 flow
// warp optionally computed in registers; and the whole contrast-maximization
// ascent over that pair as one thread-block-cluster kernel.
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
// directions are sparse: an event touches at most 6 x 6 pixels. A wgmma form
// of the dense A^T B would be 1.4 GFLOP per splat at 180 x 240 and N =
// 16,384 in TF32, and the reference holds the image to full f32: the tensor
// cores do not apply.
//
// What bounds the pair: nothing on the device. The bytes that must move are
// 12 N + 4 H W forward (369 KB at N = 16,384: 0.11 us at 3.35 TB/s) and
// 16 N + 4 H W + 12 for the SE2 VJP (0.17 us), below what any launch costs;
// the image (173 KB; 346 KB as the forward's fixed-point sums) lives in L2.
// What is scarce is launches and the host's time per launch, so the design
// removes launches and bytes around the kernels rather than cycles inside
// them:
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
// The pair's hottest caller, the contrast-maximization ascent
// (event/contrast_max.maximize_rt2d: 81 of a window's 89 forward launches
// and all 40 VJPs, ~37 launches and an autograd pass per step when it
// called the pair), is one kernel of its own, splat_ascent_kernel: one
// thread-block cluster of kAscentCluster = 16 blocks (above the portable 8,
// allowed on this card) on neighbouring SMs runs every step, so a call is
// one launch and the host waits on nothing. What bounds it is not bytes
// (13 N in, 20 out) but the f32 work of 1 + iters splats and the gathers on
// 16 of the 132 SMs, the latency of the cluster's shared memory and the
// cluster barriers (three per step with a gradient, two without). Its
// layout:
// - block r owns a band of image rows (two buffers, the current image and
//   the trial, as the forward's 64-bit fixed-point sums) and a share of
//   the events, loaded once per call by bulk copies (cp.async.bulk) that
//   complete on an mbarrier and kept for every step;
// - each step, every block warps its own events (load_coords<true>, the
//   pair's warp) into (x, y) and (w, t, d/d omega) in its shared memory;
//   every block then reads the warped (x, y) of all blocks through the
//   cluster (distributed shared memory), one event index of each block per
//   thread and round so the remote loads overlap, compacts the events that
//   can reach its rows into a list (a block-wide scan of the hit counts:
//   a fixed order), and all its threads take the list in turn: the scatter
//   adds their taps in its band with shared-memory atomics only, and the
//   gather (the VJP) sums their taps of its band's cotangent. A 64-bit add
//   in shared memory is a compare-and-swap loop on this card, so a tap goes
//   in as two native 32-bit atomics, the low word's carry into the high
//   word: the same sum. (A first version in which each block scattered its
//   own events' taps into the owners' bands with remote 64-bit atomics, and
//   gathered remote taps, ran slower on the card, with 8 blocks and with
//   16.)
// - the contrast is reduced in a fixed order (each band's sums in f64,
//   then the bands in rank order, read by every block), so every block
//   holds the same contrast and takes the same decision with no
//   broadcast; the accept test and the step use the loop's f32 op order
//   (__fmul_rn, __fadd_rn, __fdiv_rn); on accept the buffers swap;
// - where the current point changed, the cotangent of the contrast,
//   2 (img - mu) / HW less its mean, goes into the free buffer and the
//   gather runs (a rejected step leaves the point, and so the gradient, as
//   they were: the loop computes the same bits again); the gradient is
//   summed in a fixed order (threads, warps, blocks in rank order), so a
//   call gives the same bits every run.
// It reuses the pair's device functions (load_coords<true>, the f32 tap
// test in scatter_taps and gather_taps), so a warped coordinate equals the
// plain one bit for bit and no tap at |d| = trunc flips.
//
// A per-block copy of the image in shared memory for the pair was reckoned
// and not built: 180 x 240 f32 = 173 KB allows one block per SM, and each
// block must flush 43,200 pixels with global atomics at its end. That beats
// the 36 N scalar atomics of the direct form only with fewer than 36 N /
// 43,200 blocks: 13 at N = 16,384 and 54 at N = 65,536, i.e. with most of
// the 132 SMs idle.
//
// Semantics that must match the plain versions (ops/hopper_splat.py,
// event/contrast_max._ascent_loop):
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
//   a flag that the conversion kernel reads; in the ascent the image's
//   contrast is then NaN and no step is taken;
// - the VJP writes NaN where the plain VJP is not finite: every output of
//   an event with a NaN coordinate, the x (y) derivative of an event whose
//   x (y) is +-inf, and both derivatives under a non-finite weight.
//
// Plain C interface for ctypes. The entries launch on the given stream,
// allocate nothing, never synchronise and read nothing back (they can be
// captured in a CUDA graph); outputs and scratch come from the wrapper,
// which raises if the returned cudaError is not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxTap = 16;
constexpr int kAscentTap = 8;                  // the ascent's ntap bound: trunc < 3.5
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kFixScale = 4294967296.0f;     // 2^32: fixed-point units per 1.0
constexpr double kFixUnit = 1.0 / 4294967296.0;
constexpr float kMaxWeight = 65536.0f;         // 2^16

constexpr int kAscentCluster = 16;             // blocks of the ascent's one cluster
constexpr int kAscentThreads = 512;
constexpr int kAscentWarps = kAscentThreads / 32;
constexpr int kAscentHeader = 1024;            // bytes of AscentShared, padded
constexpr int kAscentList = 1024;              // reaching events a block takes per pass
constexpr int kSmemMax = 232448;               // dynamic shared memory a block may use

struct Events {
  const float* xy;      // (n, 2)
  const float* t;       // (n,), SE2 only
  const void* w;        // (n,) f32 weights, or (n,) bool mask
  int w_is_mask;
  const float* params;  // (3,) omega, vx, vy, SE2 only
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

// v into the 64-bit sum at shared-memory address p as two native 32-bit
// atomics, the low word's carry into the high word: the same sum as a 64-bit
// atomicAdd, which shared memory only has as a compare-and-swap loop.
// (Each wrap of the low word is seen by the one add that caused it.)
__device__ __forceinline__ void add_fix64_shared(unsigned long long* p, unsigned long long v) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  const unsigned int lo = (unsigned int)v;
  unsigned int hi = (unsigned int)(v >> 32);
  if (lo != 0u) {
    unsigned int old;
    asm volatile("atom.shared.add.u32 %0, [%1], %2;" : "=r"(old) : "r"(addr), "r"(lo) : "memory");
    hi += (old + lo < old) ? 1u : 0u;
  }
  if (hi != 0u) asm volatile("red.shared.add.u32 [%0], %1;" :: "r"(addr + 4u), "r"(hi) : "memory");
}

// Row h of the forward's fixed-point sums in device memory.
struct GlobalAcc {
  unsigned long long* acc;
  int W;
  __device__ bool owns(int) const { return true; }
  __device__ unsigned long long* operator()(int h) const { return acc + (ptrdiff_t)h * W; }
  __device__ void add(unsigned long long* p, unsigned long long v) const { atomicAdd(p, v); }
};

// Row h of a cotangent in device memory, read through the read-only path.
struct GlobalRows {
  const float* g;
  int W;
  __device__ bool owns(int) const { return true; }
  __device__ const float* operator()(int h) const { return g + (ptrdiff_t)h * W; }
  __device__ float load(const float* p) const { return __ldg(p); }
};

// Rows [row0, row0 + nrows) of an image in this block's shared memory:
// 64-bit fixed-point sums (T = unsigned long long) or f32 (T = float).
template <class T>
struct BandRows {
  T* band;
  int row0, nrows, W;
  __device__ bool owns(int h) const { return (unsigned)(h - row0) < (unsigned)nrows; }
  __device__ T* operator()(int h) const { return band + (ptrdiff_t)(h - row0) * W; }
  __device__ void add(unsigned long long* p, unsigned long long v) const {
    add_fix64_shared(p, v);
  }
  __device__ float load(const float* p) const { return *p; }
};

// One event's taps into rows(h) as 64-bit fixed-point sums, the rows that
// `rows` owns. Returns true, and adds nothing, if the event poisons the
// image (a NaN coordinate or a weight out of range).
template <int kTap = kMaxTap, class Rows>
__device__ __forceinline__ bool scatter_taps(const Rows& rows, float x, float y, float w,
                                             int H, int W, float inv2s2, float trunc,
                                             int ntap) {
  if (isnan(x) || isnan(y) || !(fabsf(w) < kMaxWeight)) return true;
  if (w == 0.0f || !near_image(x, y, H, W, trunc)) return false;

  const int h0 = (int)floorf(y - trunc);
  const int c0 = (int)floorf(x - trunc);
  float gx[kTap];
#pragma unroll
  for (int b = 0; b < kTap; ++b) {
    gx[b] = 0.0f;
    if (b < ntap) {
      const int c = c0 + b;
      const float dx = (float)c - x;
      if (c >= 0 && c < W && fabsf(dx) <= trunc) gx[b] = expf(-dx * dx * inv2s2);
    }
  }

  for (int a = 0; a < ntap; ++a) {
    const int h = h0 + a;
    if (h < 0 || h >= H || !rows.owns(h)) continue;
    const float dy = (float)h - y;
    if (!(fabsf(dy) <= trunc)) continue;
    const float gy = expf(-dy * dy * inv2s2) * w;
    unsigned long long* row = rows(h) + c0;
#pragma unroll
    for (int b = 0; b < kTap; ++b) {
      if (gx[b] != 0.0f) {
        rows.add(row + b, (unsigned long long)__float2ll_rn(gy * gx[b] * kFixScale));
      }
    }
  }
  return false;
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
  if (scatter_taps(GlobalAcc{acc, W}, co.x, co.y, load_weight(ev, i), H, W, inv2s2, trunc,
                   ntap)) {
    *poison = 1ull;
  }
}

// A fixed-point sum as f32.
__device__ __forceinline__ float fix_to_float(unsigned long long v) {
  return (float)((double)(long long)v * kFixUnit);
}

// One thread per pixel: the fixed-point sum as f32, or NaN if poisoned.
__global__ void __launch_bounds__(kThreads)
splat_fwd_finish_kernel(const unsigned long long* __restrict__ acc,
                        const unsigned long long* __restrict__ poison,
                        float* __restrict__ out, int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  out[i] = *poison ? NAN : fix_to_float(acc[i]);
}

// s = sum G k, sx = sum G k (c - x) / sigma^2, sy = sum G k (h - y) / sigma^2
// over the event's taps of G in the rows that `rows` owns, row h at rows(h).
template <int kTap = kMaxTap, class Rows>
__device__ __forceinline__ void gather_taps(const Rows& rows, float x, float y, int H, int W,
                                            float inv2s2, float trunc, int ntap, float& s,
                                            float& sx, float& sy) {
  s = sx = sy = 0.0f;
  if (!near_image(x, y, H, W, trunc)) return;
  const int h0 = (int)floorf(y - trunc);
  const int c0 = (int)floorf(x - trunc);
  float gx[kTap], dxs[kTap];
#pragma unroll
  for (int b = 0; b < kTap; ++b) {
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
    if (h < 0 || h >= H || !rows.owns(h)) continue;
    const float dy = (float)h - y;
    if (!(fabsf(dy) <= trunc)) continue;
    const float gy = expf(-dy * dy * inv2s2);
    const float* row = rows(h) + c0;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int b = 0; b < kTap; ++b) {
      if (b < ntap && gx[b] != 0.0f) {
        const float gk = rows.load(row + b) * gx[b];
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

// One event's VJP sums (s, sx, sy), NaN where the plain VJP is not finite.
template <int kTap = kMaxTap, class Rows>
__device__ __forceinline__ void vjp_event(const Rows& rows, float x, float y, float w, int H,
                                          int W, float inv2s2, float trunc, int ntap,
                                          float& s, float& sx, float& sy) {
  if (isnan(x) || isnan(y)) {
    s = sx = sy = NAN;
    return;
  }
  gather_taps<kTap>(rows, x, y, H, W, inv2s2, trunc, ntap, s, sx, sy);
  const bool bad_w = !isfinite(w);
  sx = (isinf(x) || bad_w) ? NAN : w * sx;
  sy = (isinf(y) || bad_w) ? NAN : w * sy;
}

// d/d(omega, vx, vy) of one event through the SE2 warp:
// d(xw)/d(omega) = t (-sa rx - ca ry), d(yw)/d(omega) = t (ca rx - sa ry),
// d(xw)/d(vx) = d(yw)/d(vy) = -t
__device__ __forceinline__ void se2_chain(const Coords& co, float sx, float sy, float& d0,
                                          float& d1, float& d2) {
  d0 = co.t * (sx * (-co.sa * co.rx - co.ca * co.ry) + sy * (co.ca * co.rx - co.sa * co.ry));
  d1 = -co.t * sx;
  d2 = -co.t * sy;
}

// The block's sums of (d0, d1, d2) in a fixed order (warp shuffles, then
// the warps in order) into out[0..2], written by threads 0-2.
template <int kNWarps>
__device__ __forceinline__ void block_sum3(float d0, float d1, float d2, float (*red)[3],
                                           float* out) {
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
    for (int k = 0; k < kNWarps; ++k) acc += red[k][threadIdx.x];
    out[threadIdx.x] = acc;
  }
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
    float s, sx, sy;
    vjp_event(GlobalRows{g, W}, co.x, co.y, load_weight(ev, i), H, W, inv2s2, trunc, ntap,
              s, sx, sy);
    if constexpr (kSe2) {
      se2_chain(co, sx, sy, d0, d1, d2);
    } else {
      if (g_xy != nullptr) ((float2*)g_xy)[i] = make_float2(sx, sy);
      if (g_w != nullptr) g_w[i] = s;
    }
  }
  if constexpr (kSe2) {
    __shared__ float red[kWarps][3];
    block_sum3<kWarps>(d0, d1, d2, red, partials + blockIdx.x * 3);
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

// ------------------------------------------------------------------ ascent

struct AscentArgs {
  const float* xy;       // (n, 2) unwarped, 16-byte aligned
  const float* t;        // (n,), 16-byte aligned
  const void* w;         // (n,) bool mask or f32 weights, 16-byte aligned
  int w_is_mask;
  const float* params0;  // (3,) the start
  float* out;            // (5,): omega, vx, vy, best contrast, start contrast
  float* trace;          // (iters + 1, 4) (omega, vx, vy, contrast) or nullptr
  float cx, cy, inv2s2, trunc, lr, inv_hw, scale0;
  int n, H, W, iters, ntap, rows, per_rank;
};

// What a block keeps besides its two image bands and its events.
struct __align__(16) AscentShared {
  unsigned long long bar;             // mbarrier of the events' bulk copies
  double moments[2];                  // the band's sum and sum of squares
  float grad[4];                      // the block's dL/d(omega, vx, vy)
  float p_trial[4];                   // the point the events are warped to
  double red_d[kAscentWarps][2];
  float red_f[kAscentWarps][3];
  int warp_hits[kAscentWarps];
};
static_assert(sizeof(AscentShared) <= kAscentHeader, "AscentShared outgrew its header");

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Dynamic shared memory of one ascent block: the header, two bands of
// `rows` image rows as 64-bit sums, per_rank events: the inputs (xy 8
// bytes, t 4, the weight 1 or 4) and the warped ones ((x, y) 8 and
// (w, t, a, b) 16), and the list of events that reach the band (16 bytes
// each).
__host__ __device__ constexpr size_t ascent_smem_bytes(int rows, int W, int per_rank,
                                                       int w_is_mask) {
  return kAscentHeader + 2 * round16((size_t)rows * W * 8) +
         (size_t)per_rank * (12 + (w_is_mask ? 1 : 4) + 24) + (size_t)kAscentList * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

struct Moments {
  float mu, c, m;   // the image's mean, its contrast, the mean of 2 (img - mu) / HW
};

// The events block k of the cluster holds.
__device__ __forceinline__ int ascent_count(const AscentArgs& a, unsigned k) {
  return max(0, min(a.n - (int)k * a.per_rank, a.per_rank));
}

// This block's events warped to the point in ev.params: where each lands
// into xw ((NaN, NaN) if it adds nothing: weight 0, away from the image,
// or poisoning), and (w, t, a, b) into aux, with d(x, y)/d(omega) = t (a, b).
// Returns, over the block, whether an event poisons the image (x) and
// whether one makes the gradient not finite (y), as the plain VJP does.
__device__ __forceinline__ int2 ascent_warp(const Events& ev, int cnt, float2* xw, float4* aux,
                                            const AscentArgs& a) {
  bool poison = false, nan_grad = false;
  for (int i = threadIdx.x; i < cnt; i += kAscentThreads) {
    const Coords co = load_coords<true>(ev, i);
    const float w = load_weight(ev, i);
    const bool bad = isnan(co.x) || isnan(co.y) || !(fabsf(w) < kMaxWeight);
    poison |= bad;
    nan_grad |= isnan(co.x) || isnan(co.y) || isinf(co.x) || isinf(co.y) || !isfinite(w);
    const bool keep = !bad && w != 0.0f && near_image(co.x, co.y, a.H, a.W, a.trunc);
    xw[i] = keep ? make_float2(co.x, co.y) : make_float2(NAN, NAN);
    aux[i] = make_float4(w, co.t, -co.sa * co.rx - co.ca * co.ry, co.ca * co.rx - co.sa * co.ry);
  }
  return make_int2(__syncthreads_or(poison), __syncthreads_or(nan_grad));
}

// Whether a warped y can have a tap in this block's rows.
__device__ __forceinline__ bool reaches(float y, const BandRows<unsigned long long>& band,
                                        float trunc) {
  return y > band.row0 - trunc - 1.0f && y < band.row0 + band.nrows + trunc;
}

// Calls f(x, y, k, i) for event i of block k, for every block's warped
// events (read through the cluster) that can reach this block's rows. A
// round takes one event index of every block per thread, so its remote
// loads are in flight together; its hits go into `list` in thread order,
// then in rank order (a block-wide scan of the hit counts gives each thread
// its slots), and every thread takes list entries in turn: the calls' order
// is fixed, and no thread idles while another works through its hits.
template <class F>
__device__ __forceinline__ void for_reaching(AscentShared& sh, float4* list, const float2* xw,
                                             const BandRows<unsigned long long>& band,
                                             const AscentArgs& a, F&& f) {
  cg::cluster_group cluster = cg::this_cluster();
  if (band.nrows <= 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < a.per_rank; base += kAscentThreads) {
    const int i = base + threadIdx.x;
    float2 q[kAscentCluster];
    unsigned hits = 0u;
#pragma unroll
    for (int k = 0; k < kAscentCluster; ++k) {
      q[k] = i < ascent_count(a, k) ? cluster.map_shared_rank(xw, (unsigned)k)[i]
                                    : make_float2(NAN, NAN);
    }
#pragma unroll
    for (int k = 0; k < kAscentCluster; ++k) hits |= reaches(q[k].y, band, a.trunc) ? 1u << k : 0u;
    const int nh = __popc(hits);
    int incl = nh;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, m);
      if (lane >= m) incl += v;
    }
    if (lane == 31) sh.warp_hits[warp] = incl;
    __syncthreads();
    int off = incl - nh, total = 0;
    for (int w = 0; w < kAscentWarps; ++w) {
      const int c = sh.warp_hits[w];
      off += w < warp ? c : 0;
      total += c;
    }
    __syncthreads();
    for (int p0 = 0; p0 < total; p0 += kAscentList) {
      int slot = off;
#pragma unroll
      for (int k = 0; k < kAscentCluster; ++k) {
        if ((hits >> k) & 1u) {
          if (slot >= p0 && slot < p0 + kAscentList) {
            list[slot - p0] = make_float4(q[k].x, q[k].y, __int_as_float(k), __int_as_float(i));
          }
          ++slot;
        }
      }
      __syncthreads();
      const int m = min(kAscentList, total - p0);
      for (int j = threadIdx.x; j < m; j += kAscentThreads) {
        const float4 e = list[j];
        f(e.x, e.y, __float_as_int(e.z), __float_as_int(e.w));
      }
      __syncthreads();
    }
  }
}

// Every block's warped events that reach this block's rows, into its band:
// shared-memory atomics only.
__device__ __forceinline__ void ascent_scatter(const float2* xw, const float4* aux,
                                               const BandRows<unsigned long long>& band,
                                               AscentShared& sh, float4* list,
                                               const AscentArgs& a) {
  for_reaching(sh, list, xw, band, a, [&](float x, float y, int k, int i) {
    // a mask weighs every event that reaches the image 1
    const float w = a.w_is_mask ? 1.0f : cg::this_cluster().map_shared_rank(aux, (unsigned)k)[i].x;
    scatter_taps<kAscentTap>(band, x, y, w, a.H, a.W, a.inv2s2, a.trunc, a.ntap);
  });
}

// The moments of the image whose band is `band`: each block sums its band
// (f64, threads then warps in order), then every block adds the blocks'
// sums in rank order, so every block holds the same values. NaN if a block
// saw a poisoning event.
__device__ Moments ascent_moments(AscentShared& sh, const unsigned long long* band,
                                  int band_px, bool poison, const AscentArgs& a) {
  cg::cluster_group cluster = cg::this_cluster();
  double s = 0.0, q = 0.0;
  for (int i = threadIdx.x; i < band_px; i += kAscentThreads) {
    const float v = fix_to_float(band[i]);
    s += v;
    q += (double)v * v;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, m);
    q += __shfl_down_sync(0xffffffffu, q, m);
  }
  if ((threadIdx.x & 31) == 0) {
    sh.red_d[threadIdx.x >> 5][0] = s;
    sh.red_d[threadIdx.x >> 5][1] = q;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < kAscentWarps; ++k) acc += sh.red_d[k][threadIdx.x];
    sh.moments[threadIdx.x] = (poison && threadIdx.x == 0) ? (double)NAN : acc;
  }
  cluster.sync();
  double S = 0.0, Q = 0.0;
  for (unsigned k = 0; k < cluster.num_blocks(); ++k) {
    const double* mk = cluster.map_shared_rank(sh.moments, k);
    S += mk[0];
    Q += mk[1];
  }
  const double hw = (double)a.H * a.W;
  const double mean = S / hw;
  Moments r;
  r.mu = (float)mean;
  r.c = (float)(Q / hw - mean * mean);
  r.m = (float)(2.0 * (double)a.inv_hw * (mean - (double)r.mu));
  return r;
}

// dL/d(omega, vx, vy) at the current point, whose warped events are in
// xw / aux: the contrast's cotangent of the current image into `cot` (this
// band, f32, in the free buffer), then every block's events that reach this
// band gather their taps in it; each block's sums, then every block adds
// the blocks' in rank order. NaN if nan_grad (an event the plain VJP makes
// not finite).
__device__ void ascent_grad(AscentShared& sh, float4* list, const float2* xw, const float4* aux,
                            const unsigned long long* cur, float* cot,
                            const BandRows<unsigned long long>& band, bool nan_grad,
                            const Moments& mo, const AscentArgs& a, float g[3]) {
  cg::cluster_group cluster = cg::this_cluster();
  const int band_px = max(band.nrows, 0) * a.W;
  for (int i = threadIdx.x; i < band_px; i += kAscentThreads) {
    const float d = __fsub_rn(fix_to_float(cur[i]), mo.mu);
    cot[i] = __fsub_rn(__fmul_rn(__fmul_rn(d, 2.0f), a.inv_hw), mo.m);
  }
  __syncthreads();
  const BandRows<float> rows{cot, band.row0, band.nrows, a.W};
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  for_reaching(sh, list, xw, band, a, [&](float x, float y, int k, int i) {
    const float4 e = cluster.map_shared_rank(aux, (unsigned)k)[i];   // w, t, a, b
    float s, sx, sy;
    vjp_event<kAscentTap>(rows, x, y, e.x, a.H, a.W, a.inv2s2, a.trunc, a.ntap, s, sx, sy);
    d0 += e.y * (sx * e.z + sy * e.w);
    d1 += -e.y * sx;
    d2 += -e.y * sy;
  });
  if (nan_grad && threadIdx.x == 0) d0 = d1 = d2 = NAN;
  block_sum3<kAscentWarps>(d0, d1, d2, sh.red_f, sh.grad);
  cluster.sync();
  g[0] = g[1] = g[2] = 0.0f;
  for (unsigned k = 0; k < cluster.num_blocks(); ++k) {
    const float* gk = cluster.map_shared_rank(sh.grad, k);
    g[0] += gk[0];
    g[1] += gk[1];
    g[2] += gk[2];
  }
}

// The whole ascent of event/contrast_max._ascent_loop, one cluster. Block
// r owns image rows [r rows, (r + 1) rows) and events [r per_rank,
// (r + 1) per_rank). Every thread of every block keeps the ascent's state
// (point, step, best contrast) in registers and updates it identically.
__global__ void __launch_bounds__(kAscentThreads, 1) splat_ascent_kernel(AscentArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  AscentShared& sh = *reinterpret_cast<AscentShared*>(smem);
  const size_t band_bytes = round16((size_t)a.rows * a.W * 8);
  unsigned long long* img[2] = {
      reinterpret_cast<unsigned long long*>(smem + kAscentHeader),
      reinterpret_cast<unsigned long long*>(smem + kAscentHeader + band_bytes)};
  unsigned char* ev_s = smem + kAscentHeader + 2 * band_bytes;
  const int wb = a.w_is_mask ? 1 : 4;
  float2* xy_s = reinterpret_cast<float2*>(ev_s);
  float* t_s = reinterpret_cast<float*>(ev_s + (size_t)a.per_rank * 8);
  unsigned char* w_s = ev_s + (size_t)a.per_rank * 12;
  float2* xw_s = reinterpret_cast<float2*>(ev_s + (size_t)a.per_rank * (12 + wb));
  float4* aux_s = reinterpret_cast<float4*>(ev_s + (size_t)a.per_rank * (20 + wb));
  float4* list_s = reinterpret_cast<float4*>(ev_s + (size_t)a.per_rank * (36 + wb));
  const int e0 = rank * a.per_rank;
  const int cnt = ascent_count(a, (unsigned)rank);
  const int row0 = rank * a.rows;
  const int nrows = max(0, min(a.H - row0, a.rows));
  const int band_px = nrows * a.W;

  // this block's events: one bulk copy per array (multiples of 16 events),
  // completing on the mbarrier; the tail of < 16 by plain loads
  const int bulk = cnt & ~15;
  const uint32_t bar = smem_u32(&sh.bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"((uint32_t)bulk * (12 + wb)) : "memory");
    if (bulk > 0) {
      bulk_load(xy_s, a.xy + 2 * (size_t)e0, (uint32_t)bulk * 8, bar);
      bulk_load(t_s, a.t + e0, (uint32_t)bulk * 4, bar);
      bulk_load(w_s, (const unsigned char*)a.w + (size_t)e0 * wb, (uint32_t)bulk * wb, bar);
    }
  }
  for (int i = bulk + tid; i < cnt; i += kAscentThreads) {
    xy_s[i] = ((const float2*)a.xy)[e0 + i];
    t_s[i] = a.t[e0 + i];
    for (int b = 0; b < wb; ++b) w_s[i * wb + b] = ((const unsigned char*)a.w)[(e0 + i) * wb + b];
  }
  for (int i = tid; i < band_px; i += kAscentThreads) img[0][i] = 0ull;
  float p[3] = {a.params0[0], a.params0[1], a.params0[2]};
  if (tid < 3) sh.p_trial[tid] = p[tid];
  __syncthreads();   // the mbarrier is initialised before anyone waits on it
  mbar_wait(bar, 0);

  const Events ev{(const float*)xy_s, t_s, w_s, a.w_is_mask, sh.p_trial, a.cx, a.cy};
  const bool trace = a.trace != nullptr && rank == 0 && tid == 0;
  BandRows<unsigned long long> band{img[0], row0, nrows, a.W};

  int2 flags = ascent_warp(ev, cnt, xw_s, aux_s, a);
  cluster.sync();    // every block's warped events and zeroed band
  ascent_scatter(xw_s, aux_s, band, sh, list_s, a);
  __syncthreads();
  Moments mo = ascent_moments(sh, img[0], band_px, flags.x, a);
  const float c0 = mo.c;
  float best = c0, step = a.lr, g[3] = {0.0f, 0.0f, 0.0f};
  const float scale[3] = {a.scale0, 1.0f, 1.0f};
  int cur = 0;
  bool changed = true, nan_grad = flags.y;
  if (trace) {
    a.trace[0] = p[0];
    a.trace[1] = p[1];
    a.trace[2] = p[2];
    a.trace[3] = c0;
  }

  for (int k = 0; k < a.iters; ++k) {
    if (changed) {   // the current point's events are still in xw / aux
      band.band = img[cur];
      ascent_grad(sh, list_s, xw_s, aux_s, img[cur], reinterpret_cast<float*>(img[cur ^ 1]), band,
                  nan_grad, mo, a, g);
      changed = false;
    }
    // the step, in _ascent_loop's f32 order: g * scale * scale, the norm of
    // g / scale clamped at 1e-12 (NaN stays NaN), p + step * g / norm
    float gs[3], r[3], pt[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gs[j] = __fmul_rn(__fmul_rn(g[j], scale[j]), scale[j]);
      r[j] = __fdiv_rn(gs[j], scale[j]);
    }
    const float gn = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
                                          __fmul_rn(r[2], r[2])));
    const float gnc = gn < 1e-12f ? 1e-12f : gn;
#pragma unroll
    for (int j = 0; j < 3; ++j) pt[j] = __fadd_rn(p[j], __fdiv_rn(__fmul_rn(step, gs[j]), gnc));
    if (tid < 3) sh.p_trial[tid] = pt[tid];
    __syncthreads();
    // the last cluster barrier ended every read of xw / aux and of the free band
    flags = ascent_warp(ev, cnt, xw_s, aux_s, a);
    unsigned long long* trial = img[cur ^ 1];
    for (int i = tid; i < band_px; i += kAscentThreads) trial[i] = 0ull;
    cluster.sync();   // every block's warped events and zeroed band
    band.band = trial;
    ascent_scatter(xw_s, aux_s, band, sh, list_s, a);
    __syncthreads();
    const Moments tm = ascent_moments(sh, trial, band_px, flags.x, a);
    if (trace) {
      float* row = a.trace + 4 * (k + 1);
      row[0] = pt[0];
      row[1] = pt[1];
      row[2] = pt[2];
      row[3] = tm.c;
    }
    if (tm.c > best) {   // the same decision in every thread of every block
      cur ^= 1;
      p[0] = pt[0];
      p[1] = pt[1];
      p[2] = pt[2];
      best = tm.c;
      mo = tm;
      nan_grad = flags.y;
      step = __fmul_rn(step, 1.1f);
      changed = true;
    } else {
      step = __fmul_rn(step, 0.5f);
    }
  }
  if (rank == 0 && tid == 0) {
    a.out[0] = p[0];
    a.out[1] = p[1];
    a.out[2] = p[2];
    a.out[3] = best;
    a.out[4] = c0;
  }
  cluster.sync();   // no block's shared memory goes away under a remote access
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
      acc, acc + hw, (float*)out, hw);
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

// Blocks of the ascent's cluster; the wrapper lays the image and the events
// out over them (rows per block, events per block, shared bytes).
extern "C" int splat_ascent_cluster() { return kAscentCluster; }

// The contrast-maximization ascent (event/contrast_max._ascent_loop) as one
// launch of one cluster. xy (n, 2), t (n,) and w ((n,) bool mask if
// w_is_mask, else f32) are 16-byte aligned; params0 (3,) the start. Writes
// out (5,) = (omega, vx, vy, best contrast, start contrast) and, if trace
// is given, trace (iters + 1, 4) = (omega, vx, vy, contrast) of the start
// and of every trial point. rows and per_rank (a multiple of 16) lay the
// image and the events over the cluster's blocks; smem_bytes must equal
// their dynamic shared memory.
extern "C" int splat_ascent_se2(const void* xy, const void* t, const void* w, int w_is_mask,
                                const void* params0, float cx, float cy, float lr, int iters,
                                void* out, void* trace, int n, int H, int W, float inv2s2,
                                float trunc, int ntap, float inv_hw, float scale0, int rows,
                                int per_rank, int smem_bytes, void* stream) {
  static int configured = 0;   // the dynamic shared memory the kernel is set up for
  if (ntap < 1 || ntap > kAscentTap || iters < 0 || n < 0 || rows < 1 || per_rank < 0 ||
      per_rank % 16 != 0 || (long long)rows * kAscentCluster < H ||
      (long long)per_rank * kAscentCluster < n ||
      (size_t)smem_bytes != ascent_smem_bytes(rows, W, per_rank, w_is_mask) ||
      smem_bytes > kSmemMax || (((uintptr_t)xy | (uintptr_t)t | (uintptr_t)w) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kAscentCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kAscentCluster, 1, 1);
  cfg.blockDim = dim3(kAscentThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc;
  if (smem_bytes > configured) {
    rc = cudaFuncSetAttribute(splat_ascent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
    // 16 blocks is above the portable cluster size of 8
    rc = cudaFuncSetAttribute(splat_ascent_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
    if (rc != cudaSuccess) return (int)rc;
    int clusters = 0;
    rc = cudaOccupancyMaxActiveClusters(&clusters, splat_ascent_kernel, &cfg);
    if (rc != cudaSuccess) return (int)rc;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    configured = smem_bytes;
  }
  AscentArgs a{};
  a.xy = (const float*)xy;
  a.t = (const float*)t;
  a.w = w;
  a.w_is_mask = w_is_mask;
  a.params0 = (const float*)params0;
  a.out = (float*)out;
  a.trace = (float*)trace;
  a.cx = cx;
  a.cy = cy;
  a.inv2s2 = inv2s2;
  a.trunc = trunc;
  a.lr = lr;
  a.inv_hw = inv_hw;
  a.scale0 = scale0;
  a.n = n;
  a.H = H;
  a.W = W;
  a.iters = iters;
  a.ntap = ntap;
  a.rows = rows;
  a.per_rank = per_rank;
  rc = cudaLaunchKernelEx(&cfg, splat_ascent_kernel, a);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
