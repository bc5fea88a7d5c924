// Batched symmetric eigendecomposition for Hopper (sm_90a): parallel
// (round-robin) Jacobi, one warp per matrix, for 2 <= n <= 16.
//
// Replaces no TPU kernel. It replaces the status-checked library calls
// torch.linalg.eigh (and, through optim/linalg.pinv_sym, torch.linalg.svd)
// that stood for jnp.linalg.eigh / jnp.linalg.svd in the port's optimizers
// and geometry. Those torch calls read cuSOLVER's `info` back on the host
// inside the operator, so every call drained the card's queue: four times
// per keyframe (the triangulations' 4 x 4 AtA) and about three times per
// inertial frame (the marginalized prior's 15 x 15 blocks), where the JAX
// reference dispatches the whole step once. This kernel reports no status
// and reads nothing back: a non-finite member gives NaN in its own outputs
// and leaves the others alone.
//
// What it computes is jnp.linalg.eigh's function: the symmetric part
// S = (A + A^T) / 2 (eigh's symmetrize_input=True), its eigenvalues w in
// ascending order and unit eigenvectors as the columns of V (as
// torch.linalg.eigh returns them), S = V diag(w) V^T. Equal eigenvalues keep
// their order on the diagonal. The sign of each column is a convention: its
// entry of largest magnitude (the first of equal ones) is made positive.
// Every caller is sign-invariant.
//
// The method: Jacobi sweeps in the round-robin order, so that each step
// rotates m/2 disjoint pairs (p, q) at once (m = n rounded up to even; an
// odd n gets a zero row and column that never rotates). Lane k < m/2
// computes pair k's rotation in Rutishauser's stable form, all in float64
// whatever the input type, so the result is at least as close to the exact
// decomposition as LAPACK's in float32; a pair is skipped when
// |s_pq| <= eps * sqrt(|s_pp s_qq|) (eps = 2^-52), the relative test under
// which Jacobi is accurate for small eigenvalues of graded matrices. Then
// the whole warp forms J^T S J (each entry from the four it mixes, in one
// order for (i, j) and (j, i), so S stays exactly symmetric; a rotated
// pair's own 2 x 2 block is set to diag(s_pp - t s_pq, s_qq + t s_pq)) into
// the other of two shared buffers, and V J in place. A member stops after a
// sweep that rotated nothing, or after kMaxSweeps. Then each lane ranks one
// eigenvalue and fixes its column's sign.
//
// What bounds it: neither the card's bytes nor its operations. A member is
// n^2 numbers in and n^2 + n out, and its function needs ~9 n^3 operations.
// At the main path's shapes (n = 4 over a frame's features, batch 512-4,096;
// n = 15, batch 1) it is latency-bound: a member's steps are a serial chain
// of a float64 rotation (divides and square roots) and a pass over shared
// memory between warp barriers, m - 1 steps per sweep, 6-10 sweeps. A warp
// per matrix keeps that chain ~7x shorter than one thread taking the pairs
// one at a time (n(n-1)/2 rotations per sweep), with the matrix in shared
// memory rather than a thread's local memory.
//
// C interface (ctypes): sym_eig(A, w, V, rotations, batch, n, is_f64,
// stream). A (batch, n, n), w (batch, n), V (batch, n, n), contiguous, all
// float32 or all float64 (is_f64); rotations, if not null, (batch,) int32
// receives each member's number of rotations (the operations a run took).
// Launches on `stream`, does not synchronise, returns the cudaError_t of
// the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // matrices per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 16;
constexpr int kLd = kMaxN + 1;            // odd row stride: column reads hit distinct banks
constexpr int kMaxSweeps = 30;
constexpr double kEps2 = 4.930380657631324e-32;  // (2^-52)^2
constexpr unsigned kFull = 0xffffffffu;

// One warp's matrix. Row i of J^T S is c[i] * row i + d[i] * row mate[i];
// an index whose pair does not rotate has c = 1, d = 0.
struct Work {
  double a[2][kMaxN * kLd];   // S, in two buffers: a step reads one, writes the other
  double v[kMaxN * kLd];      // the eigenvectors so far, as columns
  double c[kMaxN], d[kMaxN];
  double diag[kMaxN];         // a rotated index's new diagonal entry
  double sign[kMaxN];
  int mate[kMaxN];
  int turn[kMaxN];            // the index's pair rotates in this step
  int pair_p[kMaxN / 2], pair_q[kMaxN / 2];
  int src[kMaxN];             // output column -> diagonal index, ascending
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_eig_kernel(const T* __restrict__ A, T* __restrict__ w_out, T* __restrict__ V_out,
               int* __restrict__ rotations, long long batch, int n) {
  __shared__ Work work[kWarps];
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= batch) return;     // the whole warp: no block-wide barrier follows
  Work& s = work[threadIdx.x >> 5];
  const T* a_in = A + b * n * n;
  T* w_o = w_out + b * n;
  T* v_o = V_out + b * n * n;
  const int m = n + (n & 1);
  const int half = m / 2;

  bool finite = true;
  for (int k = lane; k < m * m; k += 32) {
    const int i = k / m, j = k % m;
    double x = 0.0;
    if (i < n && j < n) {
      const double aij = (double)a_in[i * n + j];
      const double aji = (double)a_in[j * n + i];
      finite = finite && isfinite(aij);
      x = 0.5 * (aij + aji);     // exact for float32 inputs; the same for (j, i)
    }
    s.a[0][i * kLd + j] = x;
    s.v[i * kLd + j] = i == j ? 1.0 : 0.0;
  }
  if (!__all_sync(kFull, finite)) {
    const T nan = (T)__longlong_as_double(0x7ff8000000000000LL);
    for (int k = lane; k < n * n; k += 32) v_o[k] = nan;
    if (lane < n) w_o[lane] = nan;
    if (lane == 0 && rotations != nullptr) rotations[b] = 0;
    return;
  }
  __syncwarp();

  int cur = 0, rot = 0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    int swept = 0;
    for (int step = 0; step < m - 1; ++step) {
      const double* a = s.a[cur];
      bool turn = false;
      if (lane < half) {
        // the round robin: index m - 1 stays, the others move one place a step
        int p = lane == 0 ? step : (step + lane) % (m - 1);
        int q = lane == 0 ? m - 1 : (step - lane + m - 1) % (m - 1);
        if (p > q) {
          const int x = p;
          p = q;
          q = x;
        }
        const double apq = a[p * kLd + q];
        const double app = a[p * kLd + p];
        const double aqq = a[q * kLd + q];
        double c = 1.0, sn = 0.0, h = 0.0;
        // |s_pq| <= eps sqrt(|s_pp s_qq|), squared: the operands are float32
        // or float64 values of an input, so no square here overflows
        if (!(apq * apq <= kEps2 * fabs(app * aqq))) {
          // Rutishauser: t = tan(phi), the smaller root of t^2 + 2 t theta = 1
          // with theta = num / den, as sign(num) den / (|num| + |(num, den)|):
          // one division, one square root
          const double num = aqq - app, den = 2.0 * apq;
          const double t = copysign(1.0, num) * den / (fabs(num) + sqrt(fma(num, num, den * den)));
          c = rsqrt(fma(t, t, 1.0));
          sn = t * c;
          h = t * apq;
          turn = true;
        }
        s.pair_p[lane] = p;
        s.pair_q[lane] = q;
        s.mate[p] = q;
        s.mate[q] = p;
        s.c[p] = c;
        s.c[q] = c;
        s.d[p] = -sn;
        s.d[q] = sn;
        s.diag[p] = app - h;
        s.diag[q] = aqq + h;
        s.turn[p] = turn;
        s.turn[q] = turn;
      }
      const unsigned turned = __ballot_sync(kFull, turn);
      __syncwarp();
      if (turned == 0) continue;
      rot += __popc(turned);
      swept += __popc(turned);
      // S <- J^T S J: entry (i, j), i <= j, from S's rows i, mate i and
      // columns j, mate j; (j, i) the same sum. V <- V J, one (row, pair)
      // at a time, in place. Lane: column (and row of V) lane % 16, every
      // other row (pair) from lane / 16. Every load of the step is issued
      // before any store, in rounds (coefficients, the entries they name,
      // then the sums), so that their latencies overlap.
      double* an = s.a[cur ^ 1];
      const int col = lane & (kMaxN - 1), row0 = lane / kMaxN;
      if (col < m) {
        constexpr int kRows = kMaxN / 2, kPairs = kMaxN / 4;
        const bool turn_col = s.turn[col];
        const int mate_col = s.mate[col];
        const double c_col = s.c[col], d_col = s.d[col], diag_col = s.diag[col];
        double cr[kRows], dr[kRows], e0[kRows], e1[kRows], e2[kRows], e3[kRows];
        int mr[kRows], pp[kPairs], qq[kPairs];
        bool tv[kPairs];
        double cv[kPairs], sv[kPairs], gv[kPairs], ev[kPairs];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int r = row0 + 2 * t;
          if (r < m) {
            cr[t] = s.c[r];
            dr[t] = s.d[r];
            mr[t] = s.mate[r];
          }
        }
#pragma unroll
        for (int t = 0; t < kPairs; ++t) {
          const int pr = row0 + 2 * t;
          if (pr < half) {
            pp[t] = s.pair_p[pr];
            qq[t] = s.pair_q[pr];
          }
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int r = row0 + 2 * t;
          if (r < m) {
            const bool lo = r <= col;
            const int i = lo ? r : col, j = lo ? col : r;
            const int ii = lo ? mr[t] : mate_col, jj = lo ? mate_col : mr[t];
            e0[t] = a[i * kLd + j];
            e1[t] = a[i * kLd + jj];
            e2[t] = a[ii * kLd + j];
            e3[t] = a[ii * kLd + jj];
          }
        }
#pragma unroll
        for (int t = 0; t < kPairs; ++t) {
          if (row0 + 2 * t < half) {
            tv[t] = s.turn[pp[t]];
            cv[t] = s.c[pp[t]];
            sv[t] = s.d[qq[t]];
            gv[t] = s.v[col * kLd + pp[t]];
            ev[t] = s.v[col * kLd + qq[t]];
          }
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int r = row0 + 2 * t;
          if (r < m) {
            const bool lo = r <= col;
            const double ci = lo ? cr[t] : c_col, di = lo ? dr[t] : d_col;
            const double cj = lo ? c_col : cr[t], dj = lo ? d_col : dr[t];
            double x = ci * (cj * e0[t] + dj * e1[t]) + di * (cj * e2[t] + dj * e3[t]);
            if (turn_col && r == col) {
              x = diag_col;           // a rotated pair's own block, exactly
            } else if (turn_col && mate_col == r) {
              x = 0.0;
            }
            an[r * kLd + col] = x;
          }
        }
#pragma unroll
        for (int t = 0; t < kPairs; ++t) {
          if (row0 + 2 * t < half && tv[t]) {
            s.v[col * kLd + pp[t]] = cv[t] * gv[t] - sv[t] * ev[t];
            s.v[col * kLd + qq[t]] = sv[t] * gv[t] + cv[t] * ev[t];
          }
        }
      }
      __syncwarp();
      cur ^= 1;
    }
    if (swept == 0) break;
  }

  const double* a = s.a[cur];
  bool ok = true;
  if (lane < n) ok = isfinite(a[lane * kLd + lane]);
  if (!__all_sync(kFull, ok)) {     // an overflow on the way
    const T nan = (T)__longlong_as_double(0x7ff8000000000000LL);
    for (int k = lane; k < n * n; k += 32) v_o[k] = nan;
    if (lane < n) w_o[lane] = nan;
    if (lane == 0 && rotations != nullptr) rotations[b] = rot;
    return;
  }
  if (lane < n) {
    // ascending: the rank of this lane's eigenvalue, equal ones in diagonal order
    const double di = a[lane * kLd + lane];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const double dj = a[j * kLd + j];
      rank += (dj < di) || (dj == di && j < lane);
    }
    // sign: the column's entry of largest magnitude is positive
    int k = 0;
    for (int r = 1; r < n; ++r) {
      if (fabs(s.v[r * kLd + lane]) > fabs(s.v[k * kLd + lane])) k = r;
    }
    s.sign[lane] = s.v[k * kLd + lane] < 0.0 ? -1.0 : 1.0;
    s.src[rank] = lane;
    w_o[rank] = (T)di;
  }
  __syncwarp();
  for (int k = lane; k < n * n; k += 32) {
    const int j = s.src[k % n];
    v_o[k] = (T)(s.sign[j] * s.v[(k / n) * kLd + j]);
  }
  if (lane == 0 && rotations != nullptr) rotations[b] = rot;
}

}  // namespace

extern "C" int sym_eig(const void* A, void* w, void* V, void* rotations, long long batch,
                       int n, int is_f64, void* stream) {
  if (n < 2 || n > kMaxN || batch < 0 || (batch + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((batch + kWarps - 1) / kWarps);
  if (is_f64) {
    sym_eig_kernel<double><<<blocks, kThreads, 0, s>>>(
        (const double*)A, (double*)w, (double*)V, (int*)rotations, batch, n);
  } else {
    sym_eig_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)A, (float*)w, (float*)V, (int*)rotations, batch, n);
  }
  return (int)cudaGetLastError();
}
