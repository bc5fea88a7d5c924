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
// and all 40 VJPs when it called the pair), is one kernel of its own,
// splat_ascent_kernel: one thread-block cluster of kAscentCluster = 16
// blocks (above the portable 8, allowed on this card) of kAscentThreads =
// 768 threads runs every step, so a call is one launch and the host waits
// on nothing. Block r owns a band of image rows and a share of the events.
// Each step is one trial image and its gradient, between two cluster
// barriers:
// - every block warps its own events (load_coords<true>, the pair's warp;
//   the raw events are re-read from device memory, L2 after the first
//   step) into (x, y, w, t), (a, b) = d(x, y)/d(omega) / t, and a one-byte
//   band code: the first and last band the event can have a tap in;
// - barrier; every block reads all blocks' band codes through the cluster
//   (distributed shared memory, 16 codes per 16-byte load), a block-wide
//   scan gives each event that reaches its band a slot in a list (a fixed
//   order), and the listed events' whole records are copied in, so the
//   taps below load nothing remote;
// - the listed events scatter their taps into the band, one thread per
//   event walking the stencil's rows and at most ntap - 1 columns from the
//   first that passes. A tap is the forward's 64-bit fixed-point value
//   (units of 2^-32), entered as three 32-bit limb sums (bits 0-15, 16-31,
//   and the rest mod 2^32) with shared atomics whose value is not used,
//   which wait on nothing: with n <= 2^16 events the two low sums cannot
//   wrap, and the recombined value is the 64-bit sum mod 2^64, so the
//   image has the forward's bits, in any order of the adds;
// - the band's moments in f64 in a fixed order (the contrast's bits), its
//   image as f32 beside it; the same listed events gather their taps of it.
//   The contrast's cotangent is affine in the image, G = 2 (img - mu) / HW
//   - m = alpha img - beta, so the gather sums G = img and G = 1 before mu
//   is known and the gradient is alpha S1 - beta S0 after the barrier;
// - every block stores its moments and gradient sums into every block's
//   shared memory (remote stores, which wait on nothing); barrier; thread 0
//   of every block adds them in rank order, so every block holds the same
//   contrast and gradient and takes the same decision with no broadcast.
//   The accept test and the step use the loop's f32 op order (__fmul_rn,
//   __fadd_rn, __fdiv_rn); an accepted trial's gradient is the next step's.
// The gradient is an f32 sum in a fixed order (threads, warps, blocks in
// rank order): the same bits every call, and within f32 rounding of the
// loop's (the cotangent's affine split rounds in another place).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; tools/ascent_phases.py and
// tools/ab_ascent.py): neither bytes (13 N in) nor f32 operations, but the
// shared-memory atomic unit and the latency of 41 serial steps on 16 SMs.
// A warp-wide red.shared.add.u32 costs ~4.3 cycles whatever its addresses
// (a 64-bit one is a compare-and-swap loop, 13-33 cycles), and each tap
// takes two; a cluster barrier ~1,500 cycles (0.75 us). At 16,384 events
// the scatter's taps are about a third of a step, the compaction (remote
// code and record loads, each a dependent round trip) a quarter, the
// gather a sixth; at 65,536 the slowest band's extra work (the edge bands
// hold fewer events) and a second page of the list add a third. The empty
// window still takes ~6 us a step: two cluster barriers and the serial
// chain of one step. Tried and measured slower on the card: eight lanes
// per event (one per column, row Gaussians shuffled: the same time at
// 16,384, 5-9% slower at 65,536), 512 or 1,024 threads (512: too few warps
// to hide latency; 1,024: 64 registers spill), loads batched into register
// arrays (spills), per-lane tests around each atomic (compiled to a branch
// and reconvergence around every one: 7% slower), every Gaussian computed
// to avoid branches (7% slower at 65,536), a separate gradient pass with
// its own compaction and barrier (three barriers and two compactions a
// step), and remote mbarrier arrives in place of a cluster barrier
// (~1,050 cycles a round, not enough to pay for the protocol).
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
constexpr int kAscentThreads = 768;            // threads of an ascent block
constexpr int kMomentThreads = 512;            // threads that sum a band's moments (their order)
constexpr int kAscentHeader = 2304;            // bytes of AscentShared, padded
constexpr int kAscentList = 3072;              // reaching events a block takes per page
constexpr int kAscentMaxEvents = 65536;        // events per call: the limb sums' range
constexpr int kAscentPhases = 11;              // ASCENT_PHASES counters per block
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

// Row h of the forward's fixed-point sums in device memory.
struct GlobalAcc {
  unsigned long long* acc;
  int W;
  __device__ unsigned long long* operator()(int h) const { return acc + (ptrdiff_t)h * W; }
  __device__ void add(unsigned long long* p, unsigned long long v) const { atomicAdd(p, v); }
};

// Row h of a cotangent in device memory, read through the read-only path.
struct GlobalRows {
  const float* g;
  int W;
  __device__ const float* operator()(int h) const { return g + (ptrdiff_t)h * W; }
  __device__ float load(const float* p) const { return __ldg(p); }
};

// One event's taps into rows(h) as 64-bit fixed-point sums. Returns true,
// and adds nothing, if the event poisons the image (a NaN coordinate or a
// weight out of range).
template <class Rows>
__device__ __forceinline__ bool scatter_taps(const Rows& rows, float x, float y, float w,
                                             int H, int W, float inv2s2, float trunc,
                                             int ntap) {
  if (isnan(x) || isnan(y) || !(fabsf(w) < kMaxWeight)) return true;
  if (w == 0.0f || !near_image(x, y, H, W, trunc)) return false;

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
    unsigned long long* row = rows(h) + c0;
#pragma unroll
    for (int b = 0; b < kMaxTap; ++b) {
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
// over the event's taps of G, row h at rows(h).
template <class Rows>
__device__ __forceinline__ void gather_taps(const Rows& rows, float x, float y, int H, int W,
                                            float inv2s2, float trunc, int ntap, float& s,
                                            float& sx, float& sy) {
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
    const float* row = rows(h) + c0;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int b = 0; b < kMaxTap; ++b) {
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
template <class Rows>
__device__ __forceinline__ void vjp_event(const Rows& rows, float x, float y, float w, int H,
                                          int W, float inv2s2, float trunc, int ntap,
                                          float& s, float& sx, float& sy) {
  if (isnan(x) || isnan(y)) {
    s = sx = sy = NAN;
    return;
  }
  gather_taps(rows, x, y, H, W, inv2s2, trunc, ntap, s, sx, sy);
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

// What a block keeps besides its image band, its events and its list.
struct __align__(16) AscentShared {
  double moments[kAscentCluster][2];  // every band's sum and sum of squares, by rank
  float grad[kAscentCluster][8];      // every block's gradient sums, by rank
  long long phase[kAscentPhases];     // ASCENT_PHASES: cycles by phase (thread 0)
  long long prof_t;                   // ASCENT_PHASES: thread 0's last mark
  float p_trial[4];                   // the point the events are warped to
  float p[4];                         // thread 0's state: the current point,
  float g[4];                         //   its gradient,
  float best, step, c0, trial_c;      //   the best contrast, the step; the trial's
  float trial_g[4];                   //   contrast and gradient
  double red_d[kMomentThreads / 32][2];
  float red_f[kAscentThreads / 32][6];
  float grad_own[8];                  // this block's gradient sums
  int warp_hits[kAscentThreads / 32];
};
static_assert(sizeof(AscentShared) <= kAscentHeader, "AscentShared outgrew its header");

#ifdef ASCENT_PHASES
// tools/ascent_phases.py: thread 0 of every block adds the cycles since its
// last mark to the mark's phase in shared memory; the kernel's end adds them
// to g_phase
__device__ unsigned long long g_phase[kAscentCluster][kAscentPhases];
#define ASCENT_MARK(ph)                         \
  do {                                         \
    if (threadIdx.x == 0) {                    \
      const long long c_ = clock64();          \
      ash().phase[ph] += c_ - ash().prof_t;    \
      ash().prof_t = c_;                       \
    }                                          \
  } while (0)
#else
#define ASCENT_MARK(ph) do { } while (0)
#endif

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Dynamic shared memory of one ascent block: the header, a band of `rows`
// image rows as three 32-bit limb planes (12 bytes a pixel) and as f32 (4),
// its per_rank events warped ((x, y, w, t) 16 bytes, (a, b) 8 and the band
// code 1), and the list of events that reach its band (24 bytes each).
__host__ __device__ constexpr size_t ascent_smem_bytes(int rows, int W, int per_rank) {
  return kAscentHeader + round16((size_t)rows * W * 12) + round16((size_t)rows * W * 4) +
         (size_t)per_rank * 25 + (size_t)kAscentList * 24;
}

// The ascent block's regions, recomputed from the launch arguments where
// they are used (so that no pointer stays live in a register across a step).
extern __shared__ __align__(16) unsigned char ascent_smem[];

__device__ __forceinline__ AscentShared& ash() {
  return *reinterpret_cast<AscentShared*>(ascent_smem);
}
__device__ __forceinline__ uint32_t* a_band() {
  return reinterpret_cast<uint32_t*>(ascent_smem + kAscentHeader);
}
__device__ __forceinline__ float* a_img(const AscentArgs& a) {
  return reinterpret_cast<float*>(ascent_smem + kAscentHeader +
                                  round16((size_t)a.rows * a.W * 12));
}
__device__ __forceinline__ unsigned char* a_events(const AscentArgs& a) {
  return ascent_smem + kAscentHeader + round16((size_t)a.rows * a.W * 12) +
         round16((size_t)a.rows * a.W * 4);
}
__device__ __forceinline__ float4* a_rec0(const AscentArgs& a) {   // (x, y, w, t)
  return reinterpret_cast<float4*>(a_events(a));
}
__device__ __forceinline__ float4* a_list0(const AscentArgs& a) {
  return reinterpret_cast<float4*>(a_events(a) + (size_t)a.per_rank * 16);
}
__device__ __forceinline__ float2* a_rec1(const AscentArgs& a) {   // (a, b)
  return reinterpret_cast<float2*>(a_events(a) + (size_t)a.per_rank * 16 + kAscentList * 16);
}
__device__ __forceinline__ float2* a_list1(const AscentArgs& a) {
  return reinterpret_cast<float2*>(a_events(a) + (size_t)a.per_rank * 24 + kAscentList * 16);
}
__device__ __forceinline__ uint8_t* a_code(const AscentArgs& a) {
  return a_events(a) + (size_t)a.per_rank * 24 + kAscentList * 24;
}

// The 64-bit fixed-point tap v into a pixel's three limb sums at p (shared
// memory), planes `plane` words apart: bits 0-15, bits 16-31, and v >> 32
// (arithmetic) mod 2^32. No add's value is used, so they compile to shared
// atomics that return nothing and wait on nothing. The low two are added
// whatever their value (a 0 adds nothing; a per-lane test compiles to a
// branch around each atomic, which serialises the taps), the high one, 0
// for every tap below 1.0 of weight, only where an active lane of the warp
// has it (a vote: the branch is the same for those lanes). A pixel takes
// at most one tap per event and n <= kAscentMaxEvents = 2^16, so the first
// two sums stay below 2^16 (2^16 - 1) < 2^32 and never wrap; the third may
// wrap, and the recombined W0 + 2^16 W1 + 2^32 W2 mod 2^64 is the sum of the
// taps mod 2^64: bit for bit the 64-bit sum of a single accumulator.
__device__ __forceinline__ void add_fix_limbs(uint32_t* p, int plane, unsigned long long v) {
  const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  atomicAdd(p, lo & 0xffffu);
  atomicAdd(p + plane, lo >> 16);
  if (__any_sync(__activemask(), hi != 0u)) atomicAdd(p + 2 * plane, hi);
}

// A pixel's three limb sums, plane k at w[k * stride], as the 64-bit sum.
__device__ __forceinline__ unsigned long long fix_limbs(const uint32_t* w, int stride) {
  return (unsigned long long)w[0] + ((unsigned long long)w[stride] << 16) +
         ((unsigned long long)w[2 * stride] << 32);
}

// The events block k of the cluster holds.
__device__ __forceinline__ int ascent_count(const AscentArgs& a, unsigned k) {
  return max(0, min(a.n - (int)k * a.per_rank, a.per_rank));
}

constexpr uint32_t kNoBand = 0x0fu;   // first band 15, last band 0: reaches none
constexpr uint32_t kNoBand4 = 0x0f0f0f0fu;   // four of them

// The bands an event at warped y can have a tap in, as first | last << 4:
// the rows the splat tests, floor(y - trunc) + [0, ntap), in the image.
__device__ __forceinline__ uint32_t band_code(float y, const AscentArgs& a) {
  const int h0 = (int)floorf(y - a.trunc);
  const int lo = max(h0, 0), hi = min(h0 + a.ntap - 1, a.H - 1);
  if (lo > hi) return kNoBand;
  return (uint32_t)(lo / a.rows) | ((uint32_t)(hi / a.rows) << 4);
}

// This block's events warped to the point in p_trial, read from device
// memory (L2 after the first step): (x, y, w, t) into rec0, (a, b) with
// d(x, y)/d(omega) = t (a, b) into rec1, and into code the bands the event
// can reach (kNoBand if it adds nothing: weight 0, away from the image, or
// poisoning; also for the padding up to per_rank). Returns, over the block,
// whether an event poisons the image (x) and whether one makes the gradient
// not finite (y), as the plain VJP does.
__device__ __forceinline__ int2 ascent_warp(const AscentArgs& a, unsigned rank) {
  const Events ev{a.xy, a.t, a.w, a.w_is_mask, ash().p_trial, a.cx, a.cy};
  const int e0 = (int)rank * a.per_rank, cnt = ascent_count(a, rank);
  float4* rec0 = a_rec0(a);
  float2* rec1 = a_rec1(a);
  uint8_t* code = a_code(a);
  bool poison = false, nan_grad = false;
  for (int i = threadIdx.x; i < a.per_rank; i += kAscentThreads) {
    uint32_t c = kNoBand;
    if (i < cnt) {
      const Coords co = load_coords<true>(ev, e0 + i);
      const float w = load_weight(ev, e0 + i);
      const bool bad = isnan(co.x) || isnan(co.y) || !(fabsf(w) < kMaxWeight);
      poison |= bad;
      nan_grad |= isnan(co.x) || isnan(co.y) || isinf(co.x) || isinf(co.y) || !isfinite(w);
      if (!bad && w != 0.0f && near_image(co.x, co.y, a.H, a.W, a.trunc)) c = band_code(co.y, a);
      rec0[i] = make_float4(co.x, co.y, w, co.t);
      rec1[i] = make_float2(-co.sa * co.rx - co.ca * co.ry, co.ca * co.rx - co.sa * co.ry);
    }
    code[i] = (uint8_t)c;
  }
  return make_int2(__syncthreads_or(poison), __syncthreads_or(nan_grad));
}

// One event's stencil on this block's band: the column Gaussians gx[b] and
// offsets dx[b] of columns c0 + b (gx 0 where the splat's f32 test
// (float)c - x, |d| <= trunc, or the image rejects the column), and the rows
// [r_lo, r_hi] that pass the same test in the band. The test picks an
// interval of rows (columns): fl((float)h - y) grows with h.
struct Stencil {
  float gx[kAscentTap], dx[kAscentTap];
  int c0, r_lo, r_hi;
};

__device__ __forceinline__ void stencil(float x, float y, int row0, const AscentArgs& a,
                                        Stencil& st) {
  const int h0 = (int)floorf(y - a.trunc);
  st.c0 = (int)floorf(x - a.trunc);
#pragma unroll
  for (int b = 0; b < kAscentTap; ++b) {
    const int c = st.c0 + b;
    const float d = (float)c - x;
    const bool on = b < a.ntap && c >= 0 && c < a.W && fabsf(d) <= a.trunc;
    st.gx[b] = on ? expf(-d * d * a.inv2s2) : 0.0f;
    st.dx[b] = on ? d : 0.0f;
  }
  int lo = max(h0, row0), hi = min(h0 + a.ntap - 1, min(row0 + a.rows, a.H) - 1);
  while (lo <= hi && !(fabsf((float)lo - y) <= a.trunc)) ++lo;
  while (hi >= lo && !(fabsf((float)hi - y) <= a.trunc)) --hi;
  st.r_lo = lo;
  st.r_hi = hi;
}

// One listed event's taps into the band's limb sums: its rows in turn, the
// columns of each unrolled and predicated (a column outside the stencil has
// gx 0, so its tap is 0 and adds nothing). Each tap is
// scatter_taps' f32 product, __float2ll_rn(gy * gx * 2^32) with gy =
// expf(-dy^2 inv2s2) w, so the sums are the forward's bit for bit.
template <int kSpan>
__device__ __forceinline__ void scatter_event(int row0, float x, float y, float w,
                                              const AscentArgs& a) {
  Stencil st;
  stencil(x, y, row0, a, st);
  // the columns that pass are consecutive, and at most kSpan = ntap - 1 of
  // them (|fl(c - x)| <= trunc holds on an interval of length 2 trunc, plus
  // an ulp: at most floor(2 trunc) + 1 integers): walk kSpan slots from the
  // first (a slot past the last has gx 0 and adds nothing)
  int first = kAscentTap;
  float gx[kSpan];
#pragma unroll
  for (int b = kAscentTap - 1; b >= 0; --b) first = st.gx[b] != 0.0f ? b : first;
#pragma unroll
  for (int u = 0; u < kSpan; ++u) {
    float v = 0.0f;
#pragma unroll
    for (int b = u; b < kAscentTap; ++b) v = b - u == first ? st.gx[b] : v;
    gx[u] = v;
  }
  const int plane = a.rows * a.W;
  for (int h = st.r_lo; h <= st.r_hi; ++h) {
    const float dy = (float)h - y;
    const float gy = expf(-dy * dy * a.inv2s2) * w;
    // the tap at column c0 + first + u (a slot past the image adds nothing)
    uint32_t* row = a_band() + (h - row0) * a.W + st.c0 + first;
#pragma unroll
    for (int u = 0; u < kSpan; ++u) {
      add_fix_limbs(row + u, plane, (unsigned long long)__float2ll_rn(gy * gx[u] * kFixScale));
    }
  }
}

// One listed event's gather sums over the band's f32 image: for the
// cotangent G = img (s[0], s[1]) and G = 1 (s[2], s[3]), sx = sum G k (c - x)
// and sy = sum G k (h - y) over its taps (without the 2 / sigma^2). Columns
// outside the stencil are not read.
__device__ __forceinline__ void gather_event(int row0, float x, float y, const AscentArgs& a,
                                             float s[4]) {
  Stencil st;
  stencil(x, y, row0, a, st);
  float kx = 0.0f, kxd = 0.0f;   // sum gx, sum gx dx
#pragma unroll
  for (int b = 0; b < kAscentTap; ++b) {
    kx += st.gx[b];
    kxd += st.gx[b] * st.dx[b];
  }
  const float* img = a_img(a) + st.c0;
  float sx1 = 0.0f, sy1 = 0.0f, ky = 0.0f, kyd = 0.0f;
  for (int h = st.r_lo; h <= st.r_hi; ++h) {
    const float dy = (float)h - y;
    const float gy = expf(-dy * dy * a.inv2s2);
    const float* row = img + (h - row0) * a.W;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int b = 0; b < kAscentTap; ++b) {
      const float gk = st.gx[b] != 0.0f ? row[b] * st.gx[b] : 0.0f;
      r0 += gk;
      r1 += gk * st.dx[b];
    }
    sx1 += gy * r1;
    sy1 += gy * dy * r0;
    ky += gy;
    kyd += gy * dy;
  }
  s[0] = sx1;
  s[1] = sy1;
  s[2] = ky * kxd;
  s[3] = kyd * kx;
}

// The block's sums of v[0..kN) in a fixed order (warp shuffles, then the
// warps in order) into out[0..kN), written by threads 0 .. kN - 1.
template <int kWarps, int kN>
__device__ __forceinline__ void block_sums(float (&v)[kN], float (*red)[6], float* out) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] += __shfl_down_sync(0xffffffffu, v[j], m);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < kN; ++j) red[threadIdx.x >> 5][j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < kN) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) acc += red[k][threadIdx.x];
    out[threadIdx.x] = acc;
  }
}

// Every block's warped events that can reach this block's band, into the
// list in pages of kAscentList: each thread reads the band codes of up to
// kChunks 16-event chunks through the cluster (a 16-byte remote load each),
// a block-wide scan of the hit counts gives every hit its slot (a fixed
// order), and fetch() copies a page's records from their blocks into the
// list.
struct Compaction {
  // per_rank <= kAscentMaxEvents / kAscentCluster chunks of 16 codes in all
  static constexpr int kChunks = (kAscentMaxEvents / kAscentCluster + kAscentThreads - 1) / kAscentThreads;
  uint32_t hits[kChunks];
  int off, nh, total;

  __device__ __forceinline__ void scan(const AscentArgs& a, unsigned rank) {
    cg::cluster_group cluster = cg::this_cluster();
    const uint8_t* code = a_code(a);
    const int cpr = a.per_rank >> 4;   // chunks per block
    // four codes at a time: first band (low nibble) <= rank <= last band
    // (high nibble), byte by byte; bit 7 of each byte's 0xff gathered into
    // 4 bits
    const uint32_t r4 = rank * 0x01010101u;
    nh = 0;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = threadIdx.x + j * kAscentThreads;
      uint32_t h = 0u;
      if (c < a.per_rank) {
        const int k = c / cpr;
        const uint4 q = *reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(code, (unsigned)k) + ((c - k * cpr) << 4));
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t m = __vcmpleu4(words[u] & 0x0f0f0f0fu, r4) &
                             __vcmpgeu4((words[u] >> 4) & 0x0f0f0f0fu, r4);
          h |= (((m & 0x80808080u) * 0x00204081u) >> 28) << (4 * u);
        }
      }
      hits[j] = h;
      nh += __popc(h);
    }
    AscentShared& sh = ash();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = nh;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, m);
      if (lane >= m) incl += v;
    }
    if (lane == 31) sh.warp_hits[warp] = incl;
    __syncthreads();
    off = incl - nh;
    total = 0;
#pragma unroll 8
    for (int w = 0; w < kAscentThreads / 32; ++w) {
      const int cw = sh.warp_hits[w];
      off += w < warp ? cw : 0;
      total += cw;
    }
  }

  // the page [p0, p0 + kAscentList) into the list: the hits' (block, index),
  // then their records (x, y, w, t) and (a, b) copied in; returns its size
  __device__ __forceinline__ int fetch(int p0, const AscentArgs& a) {
    cg::cluster_group cluster = cg::this_cluster();
    float4* lp = a_list0(a);
    float2* lq = a_list1(a);
    if (off < p0 + kAscentList && off + nh > p0) {
      const int cpr = a.per_rank >> 4;
      int slot = off;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = threadIdx.x + j * kAscentThreads;
        const int k = c / max(cpr, 1);
        const int i0 = (c - k * cpr) << 4;
        for (uint32_t h = hits[j]; h != 0u; h &= h - 1u, ++slot) {
          if (slot >= p0 && slot < p0 + kAscentList) {
            reinterpret_cast<int*>(lp + (slot - p0))[0] = (k << 16) | (i0 + __ffs(h) - 1);
          }
        }
      }
    }
    __syncthreads();
    const int m = min(kAscentList, total - p0);
    const float4* rec0 = a_rec0(a);
    const float2* rec1 = a_rec1(a);
    for (int j = threadIdx.x; j < m; j += kAscentThreads) {
      const int id = reinterpret_cast<const int*>(lp + j)[0];
      const unsigned k = (unsigned)id >> 16;
      const int i = id & 0xffff;
      const float4 r0 = cluster.map_shared_rank(rec0, k)[i];
      const float2 r1 = cluster.map_shared_rank(rec1, k)[i];
      lp[j] = r0;
      lq[j] = r1;
    }
    __syncthreads();
    return m;
  }
};

// One trial image and what the step needs of it, for the events warped to
// the trial point (rec0 / rec1 / code of every block): every block's events
// that reach this band scatter their taps into the band (zeroed), the band's
// moments (f64, kMomentThreads threads in a fixed order) with its f32 image
// beside it, then the same events gather their taps of that image for the
// gradient. The cotangent of the contrast is affine in the image, G = alpha
// img - beta (alpha = 2 / HW, beta = alpha mu + m), so the gather sums
// G = img and G = 1 and the gradient is alpha S1 - beta S0 once the moments
// are known. Each block stores its moments and its six gradient sums into
// every block's header at its rank (remote stores, which wait on nothing);
// after one cluster barrier thread 0 of every block adds them in rank order
// into trial_c and trial_g, so every block holds the same contrast and
// gradient. NaN moments if a block saw a poisoning event, NaN gradient if
// nan_grad.
template <int kSpan>
__device__ void ascent_image(const AscentArgs& a, unsigned rank, int2 flags) {
  cg::cluster_group cluster = cg::this_cluster();
  AscentShared& sh = ash();
  const int row0 = (int)rank * a.rows;
  const int nrows = max(0, min(a.H - row0, a.rows));
  Compaction cp;
  cp.total = 0;
  if (nrows > 0) {
    cp.scan(a, rank);
    ASCENT_MARK(2);
    for (int p0 = 0; p0 < cp.total; p0 += kAscentList) {
      const int m = cp.fetch(p0, a);
      ASCENT_MARK(2);
      const float4* lp = a_list0(a);
      for (int j = threadIdx.x; j < m; j += kAscentThreads) {
        const float4 e = lp[j];
        scatter_event<kSpan>(row0, e.x, e.y, e.z, a);
      }
      __syncthreads();
      ASCENT_MARK(3);
    }
  }
  // the band's moments, and its image as f32 for the gather
  {
    const int band_px = nrows * a.W, stride = a.rows * a.W;
    const uint32_t* band = a_band();
    float* img = a_img(a);
    double s = 0.0, q = 0.0;
    if (threadIdx.x < kMomentThreads) {
      for (int i = threadIdx.x; i < band_px; i += kMomentThreads) {
        const float v = fix_to_float(fix_limbs(band + i, stride));
        img[i] = v;
        s += v;
        q += (double)v * v;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, m);
      q += __shfl_down_sync(0xffffffffu, q, m);
    }
    if ((threadIdx.x & 31) == 0 && threadIdx.x < kMomentThreads) {
      sh.red_d[threadIdx.x >> 5][0] = s;
      sh.red_d[threadIdx.x >> 5][1] = q;
    }
    __syncthreads();
  }
  ASCENT_MARK(4);
  // the gather, the pages in reverse: the last is still in the list
  float d[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int last = cp.total > 0 ? (cp.total - 1) / kAscentList * kAscentList : -1;
  for (int p0 = last; p0 >= 0; p0 -= kAscentList) {
    const int m = p0 == last ? cp.total - p0 : cp.fetch(p0, a);
    ASCENT_MARK(5);
    const float4* lp = a_list0(a);
    const float2* lq = a_list1(a);
    for (int j = threadIdx.x; j < m; j += kAscentThreads) {
      const float4 e = lp[j];   // x, y, w, t
      const float2 r = lq[j];   // a, b
      float sm[4];
      gather_event(row0, e.x, e.y, a, sm);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // sx, sy as the VJP forms them: times 2 / sigma^2 and the weight
        const float sx = e.z * (sm[2 * u] * (2.0f * a.inv2s2));
        const float sy = e.z * (sm[2 * u + 1] * (2.0f * a.inv2s2));
        d[3 * u] += e.w * (sx * r.x + sy * r.y);
        d[3 * u + 1] += -e.w * sx;
        d[3 * u + 2] += -e.w * sy;
      }
    }
    if (p0 > 0) __syncthreads();   // the next page overwrites the list
  }
  if (flags.y && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) d[j] = NAN;
  }
  ASCENT_MARK(6);
  block_sums<kAscentThreads / 32, 6>(d, sh.red_f, sh.grad_own);
  // this block's moments and gradient sums into every block's header
  __syncthreads();
  if (threadIdx.x < 8) {   // thread k stores into blocks 2 k and 2 k + 1
    double mom[2] = {0.0, 0.0};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int w = 0; w < kMomentThreads / 32; ++w) mom[j] += sh.red_d[w][j];
    }
    if (flags.x) mom[0] = (double)NAN;
    const float4 g0 = make_float4(sh.grad_own[0], sh.grad_own[1], sh.grad_own[2], sh.grad_own[3]);
    const float4 g1 = make_float4(sh.grad_own[4], sh.grad_own[5], 0.0f, 0.0f);
#pragma unroll
    for (unsigned r = 2 * threadIdx.x; r < 2 * threadIdx.x + 2; ++r) {
      double* md = cluster.map_shared_rank(&sh.moments[0][0], r) + 2 * rank;
      md[0] = mom[0];
      md[1] = mom[1];
      float4* gd = reinterpret_cast<float4*>(cluster.map_shared_rank(&sh.grad[0][0], r) + 8 * rank);
      gd[0] = g0;
      gd[1] = g1;
    }
  }
  ASCENT_MARK(7);
  cluster.sync();
  ASCENT_MARK(8);
  if (threadIdx.x != 0) return;   // thread 0 keeps the ascent's state
  double S = 0.0, Q = 0.0;
  float g1[3] = {0.0f, 0.0f, 0.0f}, g0[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kAscentCluster; ++k) {
    S += sh.moments[k][0];
    Q += sh.moments[k][1];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g1[j] += sh.grad[k][j];
      g0[j] += sh.grad[k][3 + j];
    }
  }
  const double hw = (double)a.H * a.W;
  const double mean = S / hw;
  const float mu = (float)mean;
  const float m = (float)(2.0 * (double)a.inv_hw * (mean - (double)mu));
  const double alpha = 2.0 * (double)a.inv_hw;
  const double beta = alpha * (double)mu + (double)m;
  sh.trial_c = (float)(Q / hw - mean * mean);
#pragma unroll
  for (int j = 0; j < 3; ++j) sh.trial_g[j] = (float)(alpha * (double)g1[j] - beta * (double)g0[j]);
}

// The whole ascent of event/contrast_max._ascent_loop, one cluster. Block
// r owns image rows [r rows, (r + 1) rows) and events [r per_rank,
// (r + 1) per_rank). Thread 0 of every block keeps the ascent's state
// (point, gradient, best contrast, step) in its header and updates it
// identically; the other threads splat and gather. Each trial image comes with its
// gradient (ascent_image): an accepted trial's is the next step's, a
// rejected one's is dropped.
template <int kSpan>
__global__ void __launch_bounds__(kAscentThreads, 1) splat_ascent_kernel(AscentArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  AscentShared& sh = ash();
  const bool trace = a.trace != nullptr && rank == 0 && tid == 0;
  const int band_words = (int)(round16((size_t)a.rows * a.W * 12) / 16);
#ifdef ASCENT_PHASES
  if (tid < kAscentPhases) sh.phase[tid] = 0;
  if (tid == 0) sh.prof_t = clock64();
#endif
  if (tid < 3) sh.p_trial[tid] = sh.p[tid] = a.params0[tid];
  for (int i = tid; i < band_words; i += kAscentThreads) reinterpret_cast<uint4*>(a_band())[i] = uint4{0, 0, 0, 0};
  __syncthreads();
  int2 flags = ascent_warp(a, rank);
  cluster.sync();    // every block's warped events
  ASCENT_MARK(10);
  ascent_image<kSpan>(a, rank, flags);
  if (tid == 0) {
    sh.c0 = sh.best = sh.trial_c;
    sh.step = a.lr;
#pragma unroll
    for (int j = 0; j < 3; ++j) sh.g[j] = sh.trial_g[j];
    if (trace) {
      a.trace[0] = sh.p[0];
      a.trace[1] = sh.p[1];
      a.trace[2] = sh.p[2];
      a.trace[3] = sh.c0;
    }
  }

  for (int k = 0; k < a.iters; ++k) {
    if (tid == 0) {
      // the step, in _ascent_loop's f32 order: g * scale * scale, the norm
      // of g / scale clamped at 1e-12 (NaN stays NaN), p + step * g / norm
      const float scale[3] = {a.scale0, 1.0f, 1.0f};
      float gs[3], r[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gs[j] = __fmul_rn(__fmul_rn(sh.g[j], scale[j]), scale[j]);
        r[j] = __fdiv_rn(gs[j], scale[j]);
      }
      const float gn = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])), __fmul_rn(r[2], r[2])));
      const float gnc = gn < 1e-12f ? 1e-12f : gn;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sh.p_trial[j] = __fadd_rn(sh.p[j], __fdiv_rn(__fmul_rn(sh.step, gs[j]), gnc));
      }
    }
    // the last cluster barrier ended every read of rec0 / rec1 / code, and
    // the gather's of the band ended at the block's last barrier
    for (int i = tid; i < band_words; i += kAscentThreads) reinterpret_cast<uint4*>(a_band())[i] = uint4{0, 0, 0, 0};
    __syncthreads();
    ASCENT_MARK(9);
    flags = ascent_warp(a, rank);
    ASCENT_MARK(0);
    cluster.sync();   // every block's warped events
    ASCENT_MARK(1);
    ascent_image<kSpan>(a, rank, flags);
    if (tid == 0) {
      const float c = sh.trial_c;
      if (trace) {
        float* row = a.trace + 4 * (k + 1);
        row[0] = sh.p_trial[0];
        row[1] = sh.p_trial[1];
        row[2] = sh.p_trial[2];
        row[3] = c;
      }
      if (c > sh.best) {   // the same decision in every block
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sh.p[j] = sh.p_trial[j];
          sh.g[j] = sh.trial_g[j];
        }
        sh.best = c;
        sh.step = __fmul_rn(sh.step, 1.1f);
      } else {
        sh.step = __fmul_rn(sh.step, 0.5f);
      }
    }
    ASCENT_MARK(10);
  }
  if (rank == 0 && tid == 0) {
    a.out[0] = sh.p[0];
    a.out[1] = sh.p[1];
    a.out[2] = sh.p[2];
    a.out[3] = sh.best;
    a.out[4] = sh.c0;
  }
#ifdef ASCENT_PHASES
  if (tid < kAscentPhases) g_phase[rank][tid] += (unsigned long long)sh.phase[tid];
#endif
  cluster.sync();   // no block's shared memory goes away under a remote access
}

template <int kSpan>
int launch_ascent(const AscentArgs& a, int smem_bytes, cudaStream_t stream) {
  static int configured = 0;   // the dynamic shared memory the kernel is set up for
  auto kernel = splat_ascent_kernel<kSpan>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kAscentCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kAscentCluster, 1, 1);
  cfg.blockDim = dim3(kAscentThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc;
  if (smem_bytes > configured) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
    // 16 blocks is above the portable cluster size of 8
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return (int)rc;
    int clusters = 0;
    rc = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (rc != cudaSuccess) return (int)rc;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    configured = smem_bytes;
  }
  rc = cudaLaunchKernelEx(&cfg, kernel, a);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
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
// w_is_mask, else f32) are 16-byte aligned; params0 (3,) the start; n <=
// kAscentMaxEvents. Writes out (5,) = (omega, vx, vy, best contrast, start
// contrast) and, if trace is given, trace (iters + 1, 4) = (omega, vx, vy,
// contrast) of the start and of every trial point. rows and per_rank (a
// multiple of 16) lay the image and the events over the cluster's blocks;
// smem_bytes must equal their dynamic shared memory.
extern "C" int splat_ascent_se2(const void* xy, const void* t, const void* w, int w_is_mask,
                                const void* params0, float cx, float cy, float lr, int iters,
                                void* out, void* trace, int n, int H, int W, float inv2s2,
                                float trunc, int ntap, float inv_hw, float scale0, int rows,
                                int per_rank, int smem_bytes, void* stream) {
  if (ntap < 1 || ntap > kAscentTap || iters < 0 || n < 0 || n > kAscentMaxEvents || rows < 1 ||
      per_rank < 0 || per_rank % 16 != 0 || per_rank > kAscentMaxEvents / kAscentCluster ||
      (long long)rows * kAscentCluster < H ||
      (long long)per_rank * kAscentCluster < n ||
      (size_t)smem_bytes != ascent_smem_bytes(rows, W, per_rank) || smem_bytes > kSmemMax ||
      (((uintptr_t)xy | (uintptr_t)t | (uintptr_t)w) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
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
  // a row or column passes at most ntap - 1 taps
  return ntap <= 7 ? launch_ascent<6>(a, smem_bytes, (cudaStream_t)stream)
                   : launch_ascent<7>(a, smem_bytes, (cudaStream_t)stream);
}

// The ascent kernel's registers per thread, local (stack) bytes per thread,
// static shared bytes per block and threads per block into out[0..3]
// (cudaFuncGetAttributes; the instantiation that trunc < 3 launches).
extern "C" int splat_ascent_attrs(int* out) {
  cudaFuncAttributes at{};
  const cudaError_t rc = cudaFuncGetAttributes(&at, splat_ascent_kernel<6>);
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = kAscentThreads;
  return (int)rc;
}

#ifdef ASCENT_PHASES
// tools/ascent_phases.py: the phases' cycles per block (kAscentCluster x
// kAscentPhases 64-bit counts), read and zeroed
extern "C" int ascent_phase_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int ascent_phase_zero() {
  static unsigned long long z[kAscentCluster][kAscentPhases];
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
#endif
