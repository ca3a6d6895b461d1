// K2 of the fused denoiser: the per-pixel two-step Bayesian solve.
//
// Replaces bcd_tpu/ops/solve_filter_pallas.py::solve_matrices_pm (TPU kernel
// body _solve_matrices_pm_kernel, math core _two_step_solve, Jacobi
// _jacobi_clamp_psd). Per pixel p:
//   m = msum / n, Cemp = (M2 - n m m^T) / (n - 1), BD = block-diagonal noise
//   from nov / n; a fixed-schedule Jacobi eigendecomposition of Cemp - BD
//   (`sweeps` sweeps) clamps its negative eigenvalues; a Cholesky solve of
//   (clamp + BD + eps I) X = BD gives A1^T = I - X; cov2 = A1 Cemp A1^T; a
//   second solve (cov2 + BD + eps I) X2 = BD gives A2^T = I - X2 and
//   b2 = X2^T m; gate = (n >= d + 1) & center_valid and fb = center_valid &
//   !gate.
//
// What bounds it on an H100. The work is about 0.61 MFLOP a pixel at the
// engine's 4 sweeps (ops/bounds.py: the one-sided Jacobi, 27 rounds a sweep
// of 14 pivots and 14 fast-Givens row pairs of W and Q; the two Cholesky
// solves and the step-2 products), 80 GFLOP for a 131,072-pixel batch,
// 1.2 ms at 67 TFLOP/s of fp32; the bytes (5 KB a pixel) take 0.2 ms. The
// first port kept the matrices in shared memory (a row pass and a column
// pass a round) and issued about 290 shared-memory instructions a round,
// 31,000 a pixel: at one a clock per SM, 0.35 s of the default run's 0.47 s
// in this kernel (22.3 ms a batch). Shared-memory issue bound it, not the
// FMAs.
//
// The design: the TPU kernel's own Jacobi form, carried into registers.
//   - One warp a pixel; lane j holds column j of W = Q A and of Q (rows of
//     Q are the eigenvector estimates), 2 x 28 floats in registers.
//   - Rotations touch rows only (one-sided accumulation), so a round is
//     in-lane work: fast Givens with scaled rows, top' = top + alpha bot,
//     bot' = beta top + bot, one FMA per element per matrix, written
//     straight into the Brent-Luk re-seated slots: the re-seating is a
//     fixed permutation, so it costs register moves at most (ALU work).
//     Unrolling a whole sweep (its non-trivial cycle has length 27) would
//     make it pure renaming, but measured slower: 13,736 instructions that
//     spill, against one round a loop trip.
//   - The 14 pivots apq = <W[i,:], Q[i+14,:]> of a round are one warp
//     reduce-scatter by shuffles (16 of them) that leaves pair i's sum on
//     lanes 2i and 2i + 1; those lanes compute the rotation (IEEE division
//     and square root) and carry the pair's diagonal and row scales; 28
//     shuffles broadcast the coefficients, 8 re-seat the pair state.
//   - Rows are renormalized at each sweep's end; the eigenvalues are read
//     exactly as lam_k = <W[k,:], Q[k,:]>.
//   - About 56 FMAs and 52 shuffles a round replace the 290 shared-memory
//     instructions; the Jacobi loop reads and writes no shared memory.
// The clamp is formed as Cemp + sum over negative eigenvalues of
// (-lambda_k) q_k q_k^T, which equals Q^T max(Lambda, 0) Q + BD in exact
// arithmetic but carries no residual of the unconverged off-diagonal part.
// It and everything after it also work a column a lane in registers: the
// Cholesky broadcasts column j of L from lane j by shuffles and takes the
// forward substitution with it; the back substitution and the step-2
// products read 28-float rows of shared memory with 16-byte broadcast
// loads. Occupancy is what the registers allow: ptxas rounds any cap
// between 128 and 168 down to 128, and uncapped it takes 140-240, 14 warps
// an SM or fewer (10.7 ms a 131,072-pixel batch on an H100, 15 ms at 240).
// At 128 (16 warps) it fits without spilling only if no phase holds a
// whole shared-memory row in registers: the rank-k updates read 16 bytes
// at a time behind a compiler fence. Then a batch takes about 8.9 ms, about
// two thirds of it in the Jacobi, whose rotation angles (IEEE divisions
// and square roots on every lane) and shuffles are issue-bound there.
// Everything is fp32 with IEEE division and square root (no fast math).
//
// Channel maps (bcd_tpu_torch/ops/solve_filter.py): misc (P, 83) =
// [msum 27 | nov 54 | n | center_valid]; small (P, 56) =
// [b2 27 | gate | fb * m 27 | fb]; a2t (P, 729) with a2t[k * 27 + j] = A2[j][k].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 27;
constexpr int NPX = 9;
constexpr int DP = 28;                 // even size for the pairing schedule
constexpr int HALF = DP / 2;           // a round rotates rows (i, i + HALF)
constexpr int DTRI = D * (D + 1) / 2;  // packed upper triangle of M2
constexpr int MISC_CH = 83;
constexpr int SMALL_CH = 56;
constexpr int MAT = DP * DP;           // a 28 x 28 matrix, 16-byte rows
constexpr int WARPS = 2;               // pixels per block
constexpr int BLOCKS_PER_SM = 8;       // 16 warps an SM: 128 registers a lane
constexpr int PER_WARP = 3 * MAT + 32 + 64;
constexpr unsigned FULL = 0xffffffffu;

// Brent-Luk re-seating after a round: new row n takes old row from_row(n),
// [U0, D0, U1..U(h-2), D1..D(h-1), U(h-1)] with U_i the rotated row i and
// D_i the rotated row i + HALF
__host__ __device__ constexpr int from_row(int n) {
  return n == 0 ? 0
       : n == 1 ? HALF
       : n < HALF ? n - 1
       : n < DP - 1 ? n + 1
                    : HALF - 1;
}

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

// Sum over the warp of N values a lane, scattered: by recursive halving,
// lane L ends with the sum of value L / (32 / N) (N = 16: lanes 2i and
// 2i + 1 hold value i; N = 32: lane L holds value L). W is the number of
// values still held; every index is a compile-time constant.
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

template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  halve<N, N / 2>(v, lane);
  if constexpr (N == 16) return v[0] + __shfl_xor_sync(FULL, v[0], 1);
  return v[0];
}

// The per-lane Jacobi state: column `lane` of W and Q, and the diagonal
// and row scales of pair lane / 2 (lanes 28-31: an empty pair).
struct Jacobi {
  float W[DP], Q[DP];
  float app, aqq, fp, fq;
  int lane;
};

__device__ __forceinline__ void jacobi_round(Jacobi& st) {
  // pivots apq[i] = f_i f_{i+h} <W[i,:], Q[i+h,:]>, pair i's on lanes 2i, 2i+1
  float v[16];
#pragma unroll
  for (int i = 0; i < HALF; ++i) v[i] = st.W[i] * st.Q[i + HALF];
  v[14] = 0.f;
  v[15] = 0.f;
  const float sum = reduce_scatter<16>(v, st.lane);

  const float fp = st.fp, fq = st.fq;
  const float apq = sum * (fp * fq);
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = (st.aqq - st.app) / (small ? 1.f : 2.f * apq);
  float t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  if (tau == 0.f) t = 1.f;
  if (small) t = 0.f;
  const float c = 1.f / sqrtf(1.f + t * t);
  const float s = t * c;
  const float inv_cf = 1.f / (c * fp * fq);
  const float an = small ? 0.f : -s * fq * fq * inv_cf;
  const float bn = small ? 0.f : s * fp * fp * inv_cf;
  const float tapq = t * apq;
  const float app = st.app - tapq, aqq = st.aqq + tapq;
  const float fpn = c * fp, fqn = c * fq;

  // fast-Givens rows, written straight into their re-seated slots
  float w[DP], q[DP];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float a = __shfl_sync(FULL, an, 2 * i);
    const float b = __shfl_sync(FULL, bn, 2 * i);
    w[i] = fmaf(a, st.W[i + HALF], st.W[i]);
    w[i + HALF] = fmaf(b, st.W[i], st.W[i + HALF]);
    q[i] = fmaf(a, st.Q[i + HALF], st.Q[i]);
    q[i + HALF] = fmaf(b, st.Q[i], st.Q[i + HALF]);
  }
#pragma unroll
  for (int n = 0; n < DP; ++n) {
    st.W[n] = w[from_row(n)];
    st.Q[n] = q[from_row(n)];
  }

  // re-seat the pair state: new top row i is old U0 (i = 0), D0 (i = 1)
  // or U(i-1); new bottom row i + HALF is old D(i+1), or U(HALF-1) for the
  // last pair (lanes 28-31 keep theirs). Recomputed each round: a register
  // held for it costs the kernel occupancy.
  const int i = st.lane >> 1;
  const int src_p = 2 * (i >= HALF ? i : (i < 2 ? 0 : i - 1));
  const int src_q = 2 * (i >= HALF ? i : (i < HALF - 1 ? i + 1 : HALF - 1));
  const float p_app = __shfl_sync(FULL, app, src_p);
  const float p_aqq = __shfl_sync(FULL, aqq, src_p);
  const float p_fp = __shfl_sync(FULL, fpn, src_p);
  const float p_fq = __shfl_sync(FULL, fqn, src_p);
  const float q_app = __shfl_sync(FULL, app, src_q);
  const float q_aqq = __shfl_sync(FULL, aqq, src_q);
  const float q_fp = __shfl_sync(FULL, fpn, src_q);
  const float q_fq = __shfl_sync(FULL, fqn, src_q);
  st.app = i == 1 ? p_aqq : p_app;
  st.fp = i == 1 ? p_fq : p_fp;
  st.aqq = i == HALF - 1 ? q_app : q_aqq;
  st.fq = i == HALF - 1 ? q_fp : q_fq;
}

// A compiler fence for shared-memory reads: the reads after it are neither
// hoisted above it nor served from registers that held earlier reads (a
// row read ahead, the 27 noise entries of a column). Each register held
// costs the kernel occupancy.
__device__ __forceinline__ void fence_loads() { asm volatile("" ::: "memory"); }

// 16-byte broadcast read of a 28-float row of shared memory
__device__ __forceinline__ void load_row(const float* row, float (&r)[DP]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < DP / 4; ++k) {
    const float4 x = r4[k];
    r[4 * k] = x.x;
    r[4 * k + 1] = x.y;
    r[4 * k + 2] = x.z;
    r[4 * k + 3] = x.w;
  }
}

// X = (S + eps I)^-1 BD, column `lane` of each in registers: s[] holds
// column `lane` of the symmetric S on entry; eps joins each pivot as it is
// taken. A right-looking Cholesky keeps column j of L on lane j (pivots
// floored at 1e-30, scaled by 1 / L[j][j]); step j
// broadcasts that column by shuffles, updates every lane's trailing column
// and takes the forward-substitution step of the right-hand side with the
// same numbers. The back substitution reads L's columns from shared memory
// (Lt, row j = column j of L, its diagonal entry 1 / L[j][j]).
__device__ __forceinline__ void chol_solve_bd(float (&s)[DP], float (&y)[DP],
                                              const float* nov, float* Lt,
                                              float eps, int lane) {
  float r = 0.f;  // 1 / L[lane][lane]
  fence_loads();
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = bd_at(nov, i, lane);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float rj = 1.f / sqrtf(fmaxf(__shfl_sync(FULL, s[j], j) + eps, 1e-30f));
    if (lane == j) r = rj;
    // L[lane][j]: the trailing matrix is symmetric, so it is this lane's
    // own s[j] (lanes <= j keep their columns)
    const float lkj = lane > j ? s[j] * rj : 0.f;
    y[j] *= rj;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      const float l = __shfl_sync(FULL, s[i], j) * rj;  // L[i][j]
      s[i] = fmaf(-l, lkj, s[i]);
      y[i] = fmaf(-l, y[j], y[i]);
    }
  }
  __syncwarp();
  if (lane < D) {
#pragma unroll
    for (int k = 0; k < D; ++k) Lt[lane * DP + k] = (k == lane) ? r : s[k] * r;
  }
  __syncwarp();
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float row[DP];
    load_row(Lt + i * DP, row);
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) acc = fmaf(-row[k], y[k], acc);
    y[i] = acc * row[i];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * WARPS, BLOCKS_PER_SM)
solve_matrices_pm_kernel(const float* __restrict__ m2, const float* __restrict__ misc,
                      float eps, int n_pixels, int sweeps,
                      float* __restrict__ a2t, float* __restrict__ small) {
  __shared__ __align__(16) float smem[WARPS * PER_WARP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= n_pixels) return;
  float* C = smem + warp * PER_WARP;  // Cemp
  float* T = C + MAT;                 // Q, then A1^T (row-major)
  float* Lt = T + MAT;                // L^T for a solve; H in between
  float* m = Lt + MAT;                // masked mean patch, gate, fb
  float* nov = m + 32;                // mean noise blocks

  const float* mp = misc + (size_t)p * MISC_CH;
  const float n = mp[D + 6 * NPX];
  const float cv = mp[D + 6 * NPX + 1];
  const float nsafe = fmaxf(n, 1.f);
  const float nm1 = fmaxf(n - 1.f, 1.f);
  if (lane < D) m[lane] = mp[lane] / nsafe;
  if (lane == 0) {  // the gates, kept here until the output
    const float gate = (n >= (float)(D + 1) && cv > 0.f) ? 1.f : 0.f;
    m[D] = gate;
    m[D + 1] = cv * (1.f - gate);
  }
  for (int i = lane; i < 6 * NPX; i += 32) nov[i] = mp[D + i] / nsafe;
  const float* tri = m2 + (size_t)p * DTRI;
  for (int k = 0, base = 0; k < D; base += D - k, ++k)
    for (int j = k + lane; j < D; j += 32) {
      const float v = tri[base + j - k];
      C[k * DP + j] = v;
      C[j * DP + k] = v;
    }
  __syncwarp();
  for (int idx = lane; idx < D * D; idx += 32) {
    const int i = idx / D, j = idx % D;
    C[i * DP + j] = (C[i * DP + j] - n * m[i] * m[j]) / nm1;
  }
  if (lane < DP) C[D * DP + lane] = 0.f;  // row 27: the pad
  if (lane < D) C[lane * DP + D] = 0.f;
  __syncwarp();

  // Jacobi on W = Cemp - BD (zero-padded to DP), Q = I
  Jacobi st;
  st.lane = lane;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    st.W[i] = (i < D && lane < D) ? C[i * DP + lane] - bd_at(nov, i, lane) : 0.f;
    st.Q[i] = (i == lane) ? 1.f : 0.f;
  }
  {
    const int i = lane >> 1;  // this lane's pair (lanes 28-31: none)
    const int r = i + HALF;
    st.app = i < HALF && i < D ? C[i * DP + i] - bd_at(nov, i, i) : 0.f;
    st.aqq = i < HALF && r < D ? C[r * DP + r] - bd_at(nov, r, r) : 0.f;
    st.fp = st.fq = 1.f;
  }
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll 1
    for (int r = 0; r < DP - 1; ++r) jacobi_round(st);
    // renormalize: fold the scales back into the rows
#pragma unroll
    for (int r = 0; r < DP; ++r) {
      const float f = r < HALF ? __shfl_sync(FULL, st.fp, 2 * r)
                               : __shfl_sync(FULL, st.fq, 2 * (r - HALF));
      st.W[r] *= f;
      st.Q[r] *= f;
    }
    st.fp = st.fq = 1.f;
  }
  // exact eigenvalues lam_k = <W[k,:], Q[k,:]>, lane k gets its own
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < DP ? st.W[k] * st.Q[k] : 0.f;
  const float lam_k = reduce_scatter<32>(v, lane);
  const float neg = lane < DP ? fmaxf(-lam_k, 0.f) : 0.f;
  if (lane < DP) {
#pragma unroll
    for (int k = 0; k < DP; ++k) T[k * DP + lane] = st.Q[k];
  }
  __syncwarp();

  // step 1: S1 = clamp(Cemp - BD) + BD + eps I = Cemp + sum over negative
  // eigenvalues of (-lam_k) q_k q_k^T + eps I, column `lane` in registers;
  // Q[k][lane] is read back from the rows in T, so Q's registers are free
  float s[DP], y[DP];
  const int col = lane < DP ? lane : 0;  // lanes 28-31 run on a copy
#pragma unroll
  for (int i = 0; i < DP; ++i) s[i] = C[i * DP + col];
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    const float l = __shfl_sync(FULL, neg, k);
    if (l != 0.f) {
      const float coef = l * T[k * DP + col];
      const float4* r4 = reinterpret_cast<const float4*>(T + k * DP);
#pragma unroll
      for (int i4 = 0; i4 < DP / 4; ++i4) {
        fence_loads();
        const float4 q = r4[i4];
        s[4 * i4] = fmaf(coef, q.x, s[4 * i4]);
        s[4 * i4 + 1] = fmaf(coef, q.y, s[4 * i4 + 1]);
        s[4 * i4 + 2] = fmaf(coef, q.z, s[4 * i4 + 2]);
        s[4 * i4 + 3] = fmaf(coef, q.w, s[4 * i4 + 3]);
      }
    }
  }
  chol_solve_bd(s, y, nov, Lt, eps, lane);  // y = column `lane` of X1

  // step 2: cov2 = A1 Cemp A1^T. Column `lane` of A1^T = I - X1 is in y,
  // its rows in T; column `lane` of H = Cemp A1^T goes to Lt (free until
  // the second solve), then cov2[:, lane] = sum_i H[i][lane] A1^T[i][:].
#pragma unroll
  for (int k = 0; k < D; ++k) y[k] = (k == lane ? 1.f : 0.f) - y[k];
  y[D] = 0.f;
  if (lane < DP) {
#pragma unroll
    for (int k = 0; k < DP; ++k) T[k * DP + lane] = lane < D ? y[k] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float row[DP];
    load_row(C + i * DP, row);
    float h = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) h = fmaf(row[k], y[k], h);
    if (lane < DP) Lt[i * DP + lane] = h;
  }
#pragma unroll
  for (int i = 0; i < DP; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float h = Lt[i * DP + col];
    const float4* r4 = reinterpret_cast<const float4*>(T + i * DP);
#pragma unroll
    for (int k4 = 0; k4 < DP / 4; ++k4) {
      fence_loads();
      const float4 q = r4[k4];
      s[4 * k4] = fmaf(q.x, h, s[4 * k4]);
      s[4 * k4 + 1] = fmaf(q.y, h, s[4 * k4 + 1]);
      s[4 * k4 + 2] = fmaf(q.z, h, s[4 * k4 + 2]);
      s[4 * k4 + 3] = fmaf(q.w, h, s[4 * k4 + 3]);
    }
  }
  fence_loads();
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] += bd_at(nov, i, lane);
  chol_solve_bd(s, y, nov, Lt, eps, lane);  // y = column `lane` of X2 = T2^T

  // A2^T = I - X2 and b2 = X2^T m. An opaque copy of the lane number keeps
  // the compiler from holding step 1's 27 identity entries in registers
  // from there to here.
  int col2;
  asm volatile("mov.b32 %0, %1;" : "=r"(col2) : "r"(lane));
  float* out = a2t + (size_t)p * D * D;
  float b2 = 0.f;
  fence_loads();
  if (lane < D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      out[k * D + lane] = (k == col2 ? 1.f : 0.f) - y[k];
      b2 = fmaf(y[k], m[k], b2);
    }
  }
  float* sm = small + (size_t)p * SMALL_CH;
  const float gate = m[D], fb = m[D + 1];
  if (lane < D) {
    sm[lane] = b2;
    sm[D + 1 + lane] = fb * m[lane];
  }
  if (lane == 0) {
    sm[D] = gate;
    sm[2 * D + 1] = fb;
  }
}

}  // namespace

extern "C" int bcd_solve_matrices_pm(const float* m2, const float* misc,
                                     float eps, int n_pixels, int sweeps,
                                     float* a2t, float* small, void* stream) {
  if (n_pixels > 0) {
    const int blocks = (n_pixels + WARPS - 1) / WARPS;
    solve_matrices_pm_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        m2, misc, eps, n_pixels, sweeps, a2t, small);
  }
  return (int)cudaGetLastError();
}
