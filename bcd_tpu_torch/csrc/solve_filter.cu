// solve_filter and the lane-form solve_matrices: the per-pixel two-step
// Bayesian solve at the patch sizes the engine runs (d = 27 and d = 75).
//
// Replaces bcd_tpu/ops/solve_filter_pallas.py::solve_filter (TPU kernel
// body _solve_filter_kernel) and ::solve_matrices (body
// _solve_matrices_kernel, math core _two_step_solve, Jacobi
// _jacobi_clamp_psd). Per pixel p:
//   solve_filter:   M2 = sum_o mask_o c_o c_o^T over the candidate stack;
//                   the mean patch m, the set size n and the mean noise
//                   blocks are given.
//   solve_matrices: M2, the patch sums and the noise sums are given;
//                   m = msum / max(n, 1), noise = nov / max(n, 1).
//   Both: Cemp = (M2 - n m m^T) / max(n - 1, 1), BD = block-diagonal noise;
//   a fixed-schedule Jacobi eigendecomposition of Cemp - BD (`sweeps`
//   sweeps) clamps its negative eigenvalues; a Cholesky solve of
//   (clamp + BD + eps I) X = BD gives A1^T = I - X; cov2 = A1 Cemp A1^T; a
//   second solve (cov2 + BD + eps I) X2 = BD gives T2^T = X2, so
//   A2^T = I - X2 and b2 = X2^T m.
//   solve_filter writes field_o = mask_o (c_o - T2 c_o + b2) for every
//   candidate o; solve_matrices writes (A2^T, b2).
//
// What bounds it on an H100. At d = 75 (patch radius 2) the function is
// about 19.6 MFLOP a pixel (ops/bounds.py), two thirds of it the Jacobi at
// 6 sweeps: 75 rounds a sweep of 38 pivots and 38 row-pair rotations of
// two 76 x 76 matrices. The first port ran the two-sided Jacobi on three
// matrices in shared memory, a 256-thread block a pixel: 1,350 block
// barriers a pixel in the Jacobi alone, 38 of 256 threads forming the
// angles while the rest waited, and every operand a shared-memory load and
// store. Its phase clocks (PERF.md): the Jacobi 71.5% of its cycles, the
// two right-looking Cholesky solves (a barrier pair a column) 19.3%.
//
// The design: K2's register Jacobi (csrc/solve_matrices_pm.cu), spread
// over the warps of a pixel, two threads a column.
//   - One block a pixel. Thread t holds column t / 2 of W = Q A (t even)
//     or of Q (t odd) in registers, 76 floats at d = 75: 160 threads, five
//     warps (two at d = 27). A rotation touches only the thread's own
//     registers: fast Givens on rows, top' = top + alpha bot,
//     bot' = beta top + bot, one FMA per element, written straight into
//     the Brent-Luk re-seated slots (a fixed permutation of static
//     register indices).
//   - The pivots <W[i,:], Q[i+h,:]>: a W lane forms the first half of the
//     products, a Q lane the second, each taking the row it lacks from its
//     partner lane by one shuffle; a recursive-halving reduce-scatter over
//     the 16 lanes of each parity sums them over the warp's columns. A
//     block barrier makes the warps' partial sums visible; warp w forms
//     rotations [8w, 8w + 8), a lane each (summing the five partials in a
//     fixed order), and writes their coefficients and the re-seated pair
//     state (diagonals and row scales) to shared memory; a second barrier,
//     and every thread reads the coefficients as 16-byte broadcasts.
//   - Rows are renormalized at each sweep's end; the eigenvalues are read
//     exactly as lam_k = <W[k,:], Q[k,:]>.
//   - Occupancy and latency decide, not the FMAs (PERF.md has the phase
//     clocks). W and Q in one thread took 255 registers and 2 blocks an
//     SM, and ran slower than two threads a column at 128 registers (3
//     blocks, 15 warps an SM), though ptxas spills about 30 values a round
//     there. Forming each rotation in one warp, behind a second barrier,
//     instead of all of them in every warp halved the time of the angles,
//     a chain of IEEE divisions and square roots that bounds a round.
//   - The clamp is formed as Cemp + sum over negative eigenvalues of
//     (-lambda_k) q_k q_k^T, which equals Q^T max(Lambda, 0) Q + BD in
//     exact arithmetic but carries no residual of the unconverged
//     off-diagonal part.
//   - The Cholesky solves also take two threads a column: an S lane holds
//     column c of the matrix, a Y lane column c of the right-hand side. At
//     step k every S lane posts s[k] (by symmetry, row k of the trailing
//     matrix), one barrier, and every lane updates its column with the
//     broadcast column of L, the Y lanes taking the forward substitution
//     with the same numbers (eps joining each pivot as it is reached,
//     pivots floored at 1e-30); the back substitution reads L's columns
//     from shared memory as 16-byte broadcasts. One copy of the code
//     serves both solves. No integer division in these loops.
//   - The moments, the clamp, the step-2 products and the filter are
//     register-blocked a column a thread: each thread keeps a whole output
//     column in registers and reads the other operand as 16-byte broadcast
//     rows of shared memory, four FMAs a load.
// Everything is fp32 with IEEE division and square root (no fast math).
// The fp32 model of this schedule is ops/solve_filter.py::
// solve_schedule_core (its Jacobi is a function of d).
//
// Layouts (pixel-major, P pixels; bcd_tpu_torch/ops/solve_filter.py):
//   solve_filter:   cand (P, O, d), mask (P, O), noise (P, 6 npx) with the
//                   channels xx yy zz yz xz xy per patch pixel, n (P),
//                   m (P, d) -> field (P, O, d); with `rows`, block b
//                   solves pixel rows[b] and the other rows are left alone;
//   solve_matrices: m2 (P, d, d), msum (P, d), nov (P, 6 npx), n (P)
//                   -> a2t (P, d, d) with a2t[k][j] = A2[j][k], b2 (P, d).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int pad4(int x) { return (x + 3) / 4 * 4; }

template <int D>
struct Geo {
  static constexpr int NPX = D / 3;
  static constexpr int NOV = 6 * NPX;
  static constexpr int DP = D + (D & 1);  // even size for the pairing
  static constexpr int HALF = DP / 2;     // a round rotates rows (i, i + HALF)
  static constexpr int H1 = HALF / 2;     // pivots a W lane forms; a Q lane HALF - H1
  // two threads a column: thread t holds column t / 2 of W (t even) or of Q
  static constexpr int THREADS = 32 * ((2 * DP + 31) / 32);
  static constexpr int WARPS = THREADS / 32;
  // 3 blocks an SM at d = 75 (128 registers): measured faster than 2 (168
  // registers, fewer spills) and 4 (96)
  static constexpr int MIN_BLOCKS = D > 32 ? 3 : 8;
  static constexpr int MAT = DP * DP;  // row stride DP: 16-byte rows
  // shared layout in floats: C (Cemp, then H; staged candidates), T (Q
  // rows, L^T, A1^T, X2; staged candidates), m, noise, the negative
  // eigenvalues (then b2), the Cholesky's posted column (2 buffers), the
  // warps' partial sums (2 buffers), the rotation coefficients and the
  // pair state (2 buffers)
  static constexpr int C_OFF = 0;
  static constexpr int T_OFF = C_OFF + MAT;
  static constexpr int M_OFF = T_OFF + MAT;
  static constexpr int NOV_OFF = M_OFF + DP;
  static constexpr int NEG_OFF = NOV_OFF + pad4(NOV);
  static constexpr int COL_OFF = NEG_OFF + DP;
  static constexpr int PART_OFF = COL_OFF + 2 * DP;
  static constexpr int COEF_OFF = PART_OFF + 2 * WARPS * DP;
  static constexpr int ST_OFF = COEF_OFF + 2 * HALF;
  static constexpr int ST_BUF = 2 * DP;
  static constexpr int FLOATS = ST_OFF + 2 * ST_BUF;
  static constexpr int PPW = (HALF + WARPS - 1) / WARPS;  // rotations a warp forms
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

// entry (i, j) of the block-diagonal noise covariance; per patch pixel the
// six channels are xx yy zz yz xz xy
__device__ __forceinline__ float bd_at(const float* nov, int i, int j) {
  const int q = i / 3;
  if (q != j / 3) return 0.f;
  const int a = i % 3, b = j % 3;
  const int s = a + b;
  const int ch = (a == b) ? a : (s == 3 ? 3 : (s == 2 ? 4 : 5));
  return nov[6 * q + ch];
}

// Brent-Luk re-seating after a round: the new seat of old row `row`
// (seats [U0, D0, U1..U(h-2), D1..D(h-1), U(h-1)] with U_i row i and D_i
// row i + h; the inverse of ops/solve_filter.reseat_order)
template <int DP>
__host__ __device__ constexpr int to_row(int row) {
  constexpr int H = DP / 2;
  return row == 0 ? 0
       : row == H ? 1
       : row < H - 1 ? row + 1
       : row == H - 1 ? DP - 1
                      : row - 1;
}

// Recursive halving over lane bits 4 down to log2(32 / N): lane L ends with
// value L / (32 / N) summed over the lanes that differ from it in those
// bits. With N <= 16 bit 0 is never crossed, so the W lanes and the Q lanes
// reduce apart. Every index is a compile-time constant.
template <int N, int W>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  if constexpr (W >= 1) {
    constexpr int mask = W * (32 / N);
    const bool up = lane & mask;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float send = up ? v[k] : v[k + W];
      const float keep = up ? v[k + W] : v[k];
      v[k] = keep + __shfl_xor_sync(FULL, send, mask);
    }
    halve<N, W / 2>(v, lane);
  }
}

// This warp's partial sums of products of W and Q rows over its 16
// columns. A W lane (m = 0) forms W[AW + i] Q[BW + i] for i < NW into
// out[OW + i], a Q lane W[AQ + i] Q[BQ + i] for i < NQ into out[OQ + i];
// the row each needs from its partner lane comes by one shuffle a value.
// The products go in chunks of 16, 8, 4 or 2 values (from OFF on), each
// summed over the 16 lanes of the lane's parity by recursive halving.
template <int DP, int AW, int BW, int NW, int OW, int AQ, int BQ, int NQ, int OQ, int OFF = 0>
__device__ __forceinline__ void pair_sums(const float (&x)[DP], bool m, float* out,
                                          int lane) {
  constexpr int NV = NW > NQ ? NW : NQ;
  constexpr int REM = NV - OFF;
  if constexpr (REM > 0) {
    constexpr int N = REM > 8 ? 16 : (REM > 4 ? 8 : (REM > 2 ? 4 : 2));
    constexpr int G = 32 / N;
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = OFF + k;
      if (i < NV) {
        const float send = m ? (i < NW ? x[BW + i] : 0.f) : (i < NQ ? x[AQ + i] : 0.f);
        const float recv = __shfl_xor_sync(FULL, send, 1);
        v[k] = m ? (i < NQ ? recv * x[BQ + i] : 0.f) : (i < NW ? x[AW + i] * recv : 0.f);
      } else {
        v[k] = 0.f;
      }
    }
    halve<N, N / 2>(v, lane);  // lane L: value L / G over lane bits log2(G)..4
    float sum = v[0];
#pragma unroll
    for (int mask = G / 2; mask >= 2; mask /= 2) sum += __shfl_xor_sync(FULL, sum, mask);
    const int idx = OFF + lane / G;
    if (lane % G < 2 && idx < (m ? NQ : NW)) out[(m ? OQ : OW) + idx] = sum;
    pair_sums<DP, AW, BW, NW, OW, AQ, BQ, NQ, OQ, OFF + N>(x, m, out, lane);
  }
}

// A compiler fence for shared-memory reads: the reads after it are neither
// hoisted above it nor served from registers that held earlier reads.
__device__ __forceinline__ void fence_loads() { asm volatile("" ::: "memory"); }

// s[] += coef * row[], a shared-memory row read 16 bytes at a time
template <int DP>
__device__ __forceinline__ void axpy_row(float coef, const float* row, float (&s)[DP]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < DP / 4; ++k) {
    fence_loads();
    const float4 v = r4[k];
    s[4 * k] = fmaf(coef, v.x, s[4 * k]);
    s[4 * k + 1] = fmaf(coef, v.y, s[4 * k + 1]);
    s[4 * k + 2] = fmaf(coef, v.z, s[4 * k + 2]);
    s[4 * k + 3] = fmaf(coef, v.w, s[4 * k + 3]);
  }
}

// The Jacobi on W = Cemp - BD (zero-padded to DP), Q = I: `sweeps` sweeps
// of DP - 1 rounds. Thread t holds column t / 2 of W (t even) or of Q (t
// odd) in x[]; columns past DP are zero. A round: this warp's partial
// pivots, a block barrier, each warp's share of the rotations formed, a
// second barrier, the rows rotated and written re-seated. Ends, after a
// block barrier, with the negative eigenvalues max(-lam_k, 0) in NEG and
// the rows of Q in T.
template <int D>
__device__ __forceinline__ void jacobi(float* sm, int sweeps) {
  using G = Geo<D>;
  constexpr int DP = G::DP, HALF = G::HALF, H1 = G::H1, WARPS = G::WARPS;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int c = t >> 1;
  const bool m = t & 1;
  const float* C = sm + G::C_OFF;
  const float* nov = sm + G::NOV_OFF;
  float* part = sm + G::PART_OFF;
  float* coef = sm + G::COEF_OFF;
  float* st = sm + G::ST_OFF;  // pair state, buffer b at st + b * ST_BUF

  float x[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i)
    x[i] = m ? (i == c ? 1.f : 0.f) : (i < D && c < D ? C[i * DP + c] - bd_at(nov, i, c) : 0.f);
  // the pair state by seat: diagonal estimates, then row scales (set to 1
  // at each sweep's start by the rounds that read them)
  for (int s = t; s < DP; s += G::THREADS) st[s] = s < D ? C[s * DP + s] - bd_at(nov, s, s) : 0.f;
  int sb = 0, pb = 0;
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll 1
    for (int r = 0; r < DP - 1; ++r) {
      // pivots <W[i,:], Q[i+h,:]>: a W lane forms i < H1, a Q lane the rest
      pair_sums<DP, 0, HALF, H1, 0, H1, HALF + H1, HALF - H1, H1>(
          x, m, part + (pb * WARPS + warp) * DP, lane);
      __syncthreads();
      // warp w forms rotations [w PPW, (w + 1) PPW), a lane each
      const float* cur = st + sb * G::ST_BUF;
      float* nxt = st + (1 - sb) * G::ST_BUF;
      const int i = warp * G::PPW + lane;
      if (lane < G::PPW && i < HALF) {
        float sum = 0.f;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) sum += part[(pb * WARPS + v) * DP + i];
        const float app = cur[i], aqq = cur[i + HALF];
        const float fp = r == 0 ? 1.f : cur[DP + i], fq = r == 0 ? 1.f : cur[DP + i + HALF];
        const float apq = sum * (fp * fq);
        const bool small = fabsf(apq) < 1e-30f;
        const float tau = (aqq - app) / (small ? 1.f : 2.f * apq);
        float tt = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
        if (tau == 0.f) tt = 1.f;
        if (small) tt = 0.f;
        const float cs = 1.f / sqrtf(1.f + tt * tt);
        const float sn = tt * cs;
        const float inv_cf = 1.f / (cs * fp * fq);
        const float tapq = tt * apq;
        coef[2 * i] = small ? 0.f : -sn * fq * fq * inv_cf;
        coef[2 * i + 1] = small ? 0.f : sn * fp * fp * inv_cf;
        const int up = to_row<DP>(i), dn = to_row<DP>(i + HALF);
        nxt[up] = app - tapq;
        nxt[DP + up] = cs * fp;
        nxt[dn] = aqq + tapq;
        nxt[DP + dn] = cs * fq;
      }
      __syncthreads();
      // fast-Givens rows, written straight into their re-seated slots
      const float4* c4 = reinterpret_cast<const float4*>(coef);
      float nx[DP];
#pragma unroll
      for (int i2 = 0; i2 < HALF / 2; ++i2) {
        if (i2 % 2 == 0) fence_loads();  // two pairs' loads in flight, not all
        const float4 cc = c4[i2];
        const float an[2] = {cc.x, cc.z}, bn[2] = {cc.y, cc.w};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * i2 + e;
          nx[to_row<DP>(i)] = fmaf(an[e], x[i + HALF], x[i]);
          nx[to_row<DP>(i + HALF)] = fmaf(bn[e], x[i], x[i + HALF]);
        }
      }
#pragma unroll
      for (int i = 0; i < DP; ++i) x[i] = nx[i];
      sb = 1 - sb;
      pb = 1 - pb;
    }
    // renormalize: fold the row scales back into the rows
    const float4* f4 = reinterpret_cast<const float4*>(st + sb * G::ST_BUF + DP);
#pragma unroll
    for (int i4 = 0; i4 < DP / 4; ++i4) {
      fence_loads();
      const float4 f = f4[i4];
      x[4 * i4] *= f.x;
      x[4 * i4 + 1] *= f.y;
      x[4 * i4 + 2] *= f.z;
      x[4 * i4 + 3] *= f.w;
    }
  }
  // exact eigenvalues lam_k = <W[k,:], Q[k,:]>: a W lane forms k < HALF, a
  // Q lane the rest; the rows of Q to T
  pair_sums<DP, 0, 0, HALF, 0, HALF, HALF, HALF, HALF>(x, m, part + (pb * WARPS + warp) * DP,
                                                       lane);
  float* T = sm + G::T_OFF;
  if (m && c < DP) {
#pragma unroll
    for (int k = 0; k < DP; ++k) T[k * DP + c] = x[k];
  }
  __syncthreads();
  if (t < DP) {
    float lam = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) lam += part[(pb * WARPS + v) * DP + t];
    sm[G::NEG_OFF + t] = fmaxf(-lam, 0.f);
  }
  __syncthreads();
}

// X = (S + eps I)^-1 BD for the symmetric S. Thread t: column c = t / 2;
// an S lane (t even) holds column c of S in x[] on entry, a Y lane (t odd)
// starts from column c of BD and ends with column c of X. Right-looking
// Cholesky, pivots floored at 1e-30 and scaled by r_k = 1 / L[k][k]: at
// step k every S lane posts x[k] (row k of the trailing matrix, by
// symmetry), one barrier, and every lane updates its column with the
// broadcast column of L, the Y lanes taking the forward substitution with
// the same numbers. The back substitution reads L^T's rows (row k =
// column k of L, its diagonal entry r_k) from Lt. Ends with a block
// barrier.
template <int D>
__device__ __forceinline__ void chol_solve_bd(float (&x)[Geo<D>::DP], float* sm, float* Lt,
                                              float eps) {
  using G = Geo<D>;
  constexpr int DP = G::DP;
  const int t = threadIdx.x, c = t >> 1;
  const bool m = t & 1, act = c < D;
  const float* nov = sm + G::NOV_OFF;
  float* col = sm + G::COL_OFF;
  float r = 0.f;  // 1 / L[c][c] on S lanes
  fence_loads();
  if (m) {
#pragma unroll
    for (int i = 0; i < DP; ++i) x[i] = (act && i < D) ? bd_at(nov, i, c) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float* cb = col + (k & 1) * DP;
    if (!m && act) cb[c] = x[k];
    __syncthreads();
    const float rk = 1.f / sqrtf(fmaxf(cb[k] + eps, 1e-30f));
    if (c == k) r = rk;
    if (m) x[k] *= rk;
    const float g = m ? x[k] : (c > k ? x[k] * rk : 0.f);  // y[k], or L[c][k]
#pragma unroll
    for (int i = k + 1; i < D; ++i) x[i] = fmaf(-(cb[i] * rk), g, x[i]);  // L[i][k]
  }
  if (!m && act) {
#pragma unroll
    for (int k = 0; k < DP; ++k) Lt[c * DP + k] = k == c ? r : (k > c && k < D ? x[k] * r : 0.f);
  }
  __syncthreads();
  if (m) {
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      const float4* r4 = reinterpret_cast<const float4*>(Lt + i * DP);
      float acc = x[i], ri = 0.f;
#pragma unroll
      for (int k4 = i / 4; k4 < DP / 4; ++k4) {
        fence_loads();
        const float4 v = r4[k4];
        const float lv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * k4 + e;
          if (k == i) ri = lv[e];
          if (k > i && k < D) acc = fmaf(-lv[e], x[k], acc);
        }
      }
      x[i] = acc * ri;
    }
  }
  __syncthreads();
}

// The two-step solve from Cemp (in C, symmetric), the mean patch m and the
// mean noise channels. Leaves X2 = T2^T in T (row-major, X2[k][j] at
// T[k * DP + j]) and b2 in NEG, after a block barrier.
template <int D>
__device__ __forceinline__ void two_step(float* sm, float eps, int sweeps) {
  using G = Geo<D>;
  constexpr int DP = G::DP;
  const int t = threadIdx.x, c = t >> 1;
  const bool m = t & 1, act = c < D;
  const int cc = act ? c : 0;  // lanes past d run on a copy of column 0
  float* C = sm + G::C_OFF;
  float* T = sm + G::T_OFF;
  const float* mean = sm + G::M_OFF;
  const float* nov = sm + G::NOV_OFF;
  float* neg = sm + G::NEG_OFF;

  jacobi<D>(sm, sweeps);
  // step 1, on the S lanes: S1 = clamp(Cemp - BD) + BD = Cemp + sum over
  // negative eigenvalues of (-lam_k) q_k q_k^T, column c (eps joins the
  // pivots)
  float x[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) x[i] = i < D ? C[i * DP + cc] : 0.f;
  if (!m) {
#pragma unroll 1
    for (int k = 0; k < DP; ++k) {
      const float l = neg[k];
      if (l != 0.f) axpy_row<DP>(l * T[k * DP + cc], T + k * DP, x);
    }
  }
  __syncthreads();  // every lane has read T (Q) before L^T goes there
  // the two solves share one copy of the Cholesky's code: step 0 solves
  // S1 X1 = BD and forms S2 = cov2 + BD, step 1 solves S2 X2 = BD
#pragma unroll 1
  for (int step = 0;; ++step) {
    chol_solve_bd<D>(x, sm, T, eps);  // Y lanes: column c of X1, then X2
    if (step == 1) break;
    // step 2: cov2 = A1 Cemp A1^T. The Y lanes write the rows of
    // A1^T = I - X1 to T; the S lanes form column c of H = Cemp A1^T
    // (C symmetric: H[:, c] = sum_k A1^T[k][c] C[k][:]) and put it in C,
    // then cov2[:, c] = sum_i H[i][c] A1^T[i][:]
    if (m && c < DP) {
#pragma unroll
      for (int k = 0; k < DP; ++k) T[k * DP + c] = act && k < D ? (k == c ? 1.f : 0.f) - x[k] : 0.f;
    }
    __syncthreads();
    if (!m) {
#pragma unroll
      for (int i = 0; i < DP; ++i) x[i] = 0.f;
#pragma unroll 1
      for (int k = 0; k < D; ++k) axpy_row<DP>(T[k * DP + cc], C + k * DP, x);
    }
    __syncthreads();  // every lane has read C (Cemp) before H goes there
    if (!m && c < DP) {
#pragma unroll
      for (int i = 0; i < DP; ++i) C[i * DP + c] = act ? x[i] : 0.f;
    }
    __syncthreads();
    if (!m) {
#pragma unroll
      for (int a = 0; a < DP; ++a) x[a] = 0.f;
#pragma unroll 1
      for (int i = 0; i < D; ++i) axpy_row<DP>(C[i * DP + cc], T + i * DP, x);
      fence_loads();
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] += act ? bd_at(nov, i, c) : 0.f;
    }
    __syncthreads();  // every lane has read T (A1^T) before L^T goes there
  }
  // X2 to T, b2[c] = sum_k X2[k][c] m[k] to NEG
  if (m && act) {
    float b2 = 0.f;
#pragma unroll
    for (int k = 0; k < DP; ++k) {
      T[k * DP + c] = k < D ? x[k] : 0.f;
      if (k < D) b2 = fmaf(x[k], mean[k], b2);
    }
    neg[c] = b2;
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(Geo<D>::THREADS, Geo<D>::MIN_BLOCKS)
solve_filter_kernel(const float* __restrict__ cand, const float* __restrict__ mask,
                    const float* __restrict__ noise, const float* __restrict__ n_in,
                    const float* __restrict__ m_in, const int* __restrict__ rows,
                    float eps, int n_off, int sweeps, float* __restrict__ field) {
  using G = Geo<D>;
  constexpr int DP = G::DP, T = G::THREADS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* C = sm + G::C_OFF;
  float* Tb = sm + G::T_OFF;
  float* m = sm + G::M_OFF;
  float* nov = sm + G::NOV_OFF;
  // the moments and the filter work a column a thread, threads j < d
  const int j = threadIdx.x;
  const bool act = j < D;
  const int jc = act ? j : 0;
  const size_t p = rows ? rows[blockIdx.x] : blockIdx.x;
  const float* cp = cand + p * n_off * D;
  const float* wp = mask + p * n_off;
  float* fp = field + p * n_off * D;
  const float n = n_in[p];
  for (int i = j; i < DP; i += T) m[i] = i < D ? m_in[p * D + i] : 0.f;
  for (int i = j; i < G::NOV; i += T) nov[i] = noise[p * G::NOV + i];

  // M2 column j = sum_o (w_o c_o) c_o[j], over chunks of DP candidates
  // staged in shared memory (T: w_o c_o, C: c_o, rows of DP floats)
  {
    float acc[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] = 0.f;
    for (int o0 = 0; o0 < n_off; o0 += DP) {
      const int cnt = min(DP, n_off - o0);
      __syncthreads();
      for (int idx = j; idx < cnt * DP; idx += T) {
        const int o = idx / DP, i = idx - o * DP;
        const float c = i < D ? cp[(size_t)(o0 + o) * D + i] : 0.f;
        Tb[idx] = wp[o0 + o] * c;
        C[idx] = c;
      }
      __syncthreads();
      if (j < DP) {
#pragma unroll 1
        for (int o = 0; o < cnt; ++o) {
          const float cj = C[o * DP + jc];
          const float4* r4 = reinterpret_cast<const float4*>(Tb + o * DP);
#pragma unroll
          for (int i4 = 0; i4 < DP / 4; ++i4) {
            const float4 v = r4[i4];
            acc[4 * i4] = fmaf(v.x, cj, acc[4 * i4]);
            acc[4 * i4 + 1] = fmaf(v.y, cj, acc[4 * i4 + 1]);
            acc[4 * i4 + 2] = fmaf(v.z, cj, acc[4 * i4 + 2]);
            acc[4 * i4 + 3] = fmaf(v.w, cj, acc[4 * i4 + 3]);
          }
        }
      }
    }
    __syncthreads();
    // Cemp from the upper triangle (entry (i, j), i <= j, is thread j's
    // acc[i]), mirrored: thread j writes column j and row j of C down to
    // the diagonal
    const float nm1 = fmaxf(n - 1.f, 1.f);
    if (j < DP) {
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        if (i <= j) {
          const float ce = (act && i < D) ? (acc[i] - n * m[i] * m[j]) / nm1 : 0.f;
          C[i * DP + j] = ce;
          C[j * DP + i] = ce;
        }
      }
    }
  }
  __syncthreads();

  two_step<D>(sm, eps, sweeps);

  // field_o = mask_o (c_o - T2 c_o + b2): column j of X2 = T2^T from T, so
  // (T2 c_o)[j] = sum_k c_o[k] X2[k][j]; candidates staged in C in chunks
  // of DP rows
  float x2[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k) x2[k] = Tb[k * DP + jc];
  const float b2 = sm[G::NEG_OFF + jc];
  for (int o0 = 0; o0 < n_off; o0 += DP) {
    const int cnt = min(DP, n_off - o0);
    __syncthreads();
    for (int idx = j; idx < cnt * DP; idx += T) {
      const int o = idx / DP, i = idx - o * DP;
      C[idx] = i < D ? cp[(size_t)(o0 + o) * D + i] : 0.f;
    }
    __syncthreads();
    if (act) {
#pragma unroll 1
      for (int o = 0; o < cnt; ++o) {
        const float w = wp[o0 + o];
        float out = 0.f;
        if (w != 0.f) {
          const float4* r4 = reinterpret_cast<const float4*>(C + o * DP);
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
          for (int k4 = 0; k4 < DP / 4; ++k4) {
            const float4 v = r4[k4];
            s0 = fmaf(v.x, x2[4 * k4], s0);
            s1 = fmaf(v.y, x2[4 * k4 + 1], s1);
            s2 = fmaf(v.z, x2[4 * k4 + 2], s2);
            s3 = fmaf(v.w, x2[4 * k4 + 3], s3);
          }
          out = (C[o * DP + j] - ((s0 + s1) + (s2 + s3)) + b2) * w;
        }
        fp[(size_t)(o0 + o) * D + j] = out;
      }
    }
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(Geo<D>::THREADS, Geo<D>::MIN_BLOCKS)
solve_matrices_kernel(const float* __restrict__ m2, const float* __restrict__ msum,
                      const float* __restrict__ nov_in, const float* __restrict__ n_in,
                      float eps, int sweeps, float* __restrict__ a2t,
                      float* __restrict__ b2_out) {
  using G = Geo<D>;
  constexpr int DP = G::DP, T = G::THREADS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* C = sm + G::C_OFF;
  const float* Tb = sm + G::T_OFF;
  float* m = sm + G::M_OFF;
  float* nov = sm + G::NOV_OFF;
  const int j = threadIdx.x;
  const size_t p = blockIdx.x;
  const float n = n_in[p];
  const float inv_n = 1.f / fmaxf(n, 1.f);
  const float nm1 = fmaxf(n - 1.f, 1.f);
  for (int i = j; i < DP; i += T) m[i] = i < D ? msum[p * D + i] * inv_n : 0.f;
  for (int i = j; i < G::NOV; i += T) nov[i] = nov_in[p * G::NOV + i] * inv_n;
  __syncthreads();
  const float* mp = m2 + p * D * D;
  if (j < DP) {
#pragma unroll 4
    for (int i = 0; i < DP; ++i) {  // from the upper triangle: symmetric
      const int a = min(i, j), b = max(i, j);
      C[i * DP + j] = (b < D) ? (mp[a * D + b] - n * m[a] * m[b]) / nm1 : 0.f;
    }
  }
  __syncthreads();

  two_step<D>(sm, eps, sweeps);

  if (j < D) {
    float* ap = a2t + p * D * D;
#pragma unroll 4
    for (int k = 0; k < D; ++k) ap[k * D + j] = (k == j ? 1.f : 0.f) - Tb[k * DP + j];
    b2_out[p * D + j] = sm[G::NEG_OFF + j];
  }
}

template <int D>
int launch_filter(const float* cand, const float* mask, const float* noise,
                  const float* n, const float* m, const int* rows, float eps,
                  int n_pixels, int n_off, int sweeps, float* field, cudaStream_t stream) {
  using G = Geo<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_filter_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  solve_filter_kernel<D><<<n_pixels, G::THREADS, G::BYTES, stream>>>(
      cand, mask, noise, n, m, rows, eps, n_off, sweeps, field);
  return (int)cudaGetLastError();
}

template <int D>
int launch_matrices(const float* m2, const float* msum, const float* nov,
                    const float* n, float eps, int n_pixels, int sweeps,
                    float* a2t, float* b2, cudaStream_t stream) {
  using G = Geo<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_matrices_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  solve_matrices_kernel<D><<<n_pixels, G::THREADS, G::BYTES, stream>>>(
      m2, msum, nov, n, eps, sweeps, a2t, b2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bcd_solve_filter(const float* cand, const float* mask,
                                const float* noise, const float* n,
                                const float* m, const int* rows, float eps,
                                int n_pixels, int n_off, int d, int sweeps,
                                float* field, void* stream) {
  if (n_pixels <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 27)
    return launch_filter<27>(cand, mask, noise, n, m, rows, eps, n_pixels, n_off, sweeps, field, s);
  if (d == 75)
    return launch_filter<75>(cand, mask, noise, n, m, rows, eps, n_pixels, n_off, sweeps, field, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bcd_solve_matrices(const float* m2, const float* msum,
                                  const float* nov, const float* n, float eps,
                                  int n_pixels, int d, int sweeps, float* a2t,
                                  float* b2, void* stream) {
  if (n_pixels <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 27)
    return launch_matrices<27>(m2, msum, nov, n, eps, n_pixels, sweeps, a2t, b2, s);
  if (d == 75)
    return launch_matrices<75>(m2, msum, nov, n, eps, n_pixels, sweeps, a2t, b2, s);
  return (int)cudaErrorInvalidValue;
}
