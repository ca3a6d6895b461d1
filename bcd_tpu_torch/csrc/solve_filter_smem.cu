// solve_filter at patch radius 3 (d = 147), 4 (d = 243), 5 (d = 363),
// 6 (d = 507), 7 (d = 675), 8 (d = 867), 9 (d = 1083), 10 (d = 1323),
// 11 (d = 1587) and 12 (d = 1875): the per-pixel two-step Bayesian solve
// and filter of the candidate stacks, with the Jacobi's two working
// matrices in shared memory (d = 147), or as much of them as fits there
// and the rest in a global slot of the block (d = 243 to 1875).
//
// Replaces bcd_tpu/ops/solve_filter_pallas.py::solve_filter (TPU kernel
// body _solve_filter_kernel, Jacobi _jacobi_clamp_psd) at d = 147, 243, 363,
// 507, 675, 867, 1083, 1323, 1587 and 1875; it computes what
// csrc/solve_filter.cu computes at d = 27 and 75. Per pixel:
//   M2 = sum_o mask_o c_o c_o^T over the candidate stack; the mean patch m,
//   the set size n and the mean noise blocks are given.
//   Cemp = (M2 - n m m^T) / max(n - 1, 1), BD = block-diagonal noise;
//   `sweeps` sweeps of the fixed-schedule one-sided fast-Givens Jacobi of
//   Cemp - BD (Brent-Luk re-seating, rows renormalized at each sweep's
//   end) give its eigenvalues lam_k and eigenvector rows q_k; the clamp
//   S1 = Cemp + sum over lam_k < 0 of (-lam_k) q_k q_k^T; a Cholesky solve
//   (S1 + eps I) X1 = BD gives A1^T = I - X1; cov2 = A1 Cemp A1^T; a second
//   solve (cov2 + BD + eps I) X2 = BD; b2 = X2^T m, and
//   field_o = mask_o (c_o - X2^T c_o + b2) for every candidate o.
// Everything is fp32 with IEEE division and square root (no fast math).
// The exact fp32 model of this schedule is ops/solve_filter.py::
// solve_filter_pm_schedule (its Jacobi, _jacobi_fp32, is a function of d).
//
// What bounds it on an H100. About 0.17 GFLOP a pixel at d = 147, 0.75 at
// d = 243 and 2.5 at d = 363 at the engine's 8 sweeps, and 7.4 at d = 507
// at its 9 (ops/bounds.py), three quarters of it the Jacobi: d rounds a
// sweep, each (d + 1) / 2 pivot inner products and as many row-pair
// rotations of two (d + 1) x (d + 1) matrices. csrc/solve_filter.cu keeps
// a column of W or Q in a thread's registers; at d = 147 a column is 148
// floats, more than a thread can hold. Here W and Q are rows: at d = 147
// all in shared memory (2 x 148 x 148 floats, 175 KB of the 227 KB a block
// may have), so a round reads and writes both once: 350 KB of shared-
// memory traffic against 55 K FMAs, about 2,700 cycles of an SM's 128
// bytes a cycle against 430 of its FMA rate. At d = 243 the two matrices
// take 476 KB: the first 227 of their 488 rows stay in shared memory, the
// other 261 (255 KB a block, 34 MB for 132 blocks, inside the 50 MB L2) in
// a global slot of the block, and a round moves 953 KB, more than half of
// it through L2. At d = 363 they take 1.06 MB: 148 of the 728 rows (W's
// first 148) stay in shared memory beside the vectors, which take 16 KB
// there, and the other 580 (845 KB a block, 111 MB for 132 blocks, twice
// the L2) sit in the global slot, so a round moves about 2 MB a block,
// most of it to and from HBM. At d = 507 they take 2.06 MB: 103 of the
// 1,016 rows (W's first 103) stay in shared memory beside 22 KB of
// vectors, the other 913 (1.86 MB) in the global slot, which with Cemp and
// H is 3.92 MB a block, 517 MB for 132 blocks, ten times the L2: a round
// reads and writes about 3.7 MB a block from HBM, and HBM's traffic, not
// the FMAs, sets a round's least time. At d = 675 they take 3.66 MB: 72 of
// the 1,352 rows (W's first 72) stay in shared memory beside 35 KB of
// vectors (the staged Cholesky rows among them), the other 1,280 (3.46 MB)
// in the global slot, which with Cemp and H is 7.12 MB a block, 939 MB for
// 132 blocks, 19 times the L2: a round (338 pairs, six pivot passes)
// reads and writes about 6.9 MB a block in its rotations and reads 1.6 MB
// more for its pivot products, nearly all of it from HBM, and that traffic
// again bounds it. At d = 867 they take 6.03 MB: 53 of the 1,736 rows
// (W's first 53) stay in shared memory beside 45 KB of vectors (229,152 of
// the 232,448 bytes), the other 1,683 (5.84 MB) in the global slot, which
// with Cemp and H is 11.9 MB a block, 1.57 GB for 132 blocks, 31 times the
// L2: a round (434 pairs, seven pivot passes) moves about twice d = 675's
// bytes, and HBM's traffic bounds it as there. At d = 1083 they take
// 9.40 MB: 40 of the 2,168 rows (W's first 40) stay in shared memory beside
// 56 KB of vectors (229,808 of the 232,448 bytes), the other 2,128
// (9.23 MB) in the global slot, which with Cemp and H is 18.6 MB a block,
// 2.46 GB for 132 blocks, 49 times the L2: a round (542 pairs, nine pivot
// passes) moves about 1.56 times d = 867's bytes. At d = 1323 they take
// 14.0 MB: 30 of the 2,648 rows (W's first 30) stay in shared memory beside
// 69 KB of vectors (227,728 of the 232,448 bytes), the other 2,618
// (13.9 MB) in the global slot, which with Cemp and H is 27.9 MB a block,
// 3.68 GB for 132 blocks, 74 times the L2: a round (662 pairs, eleven pivot
// passes) moves about 1.5 times d = 1083's bytes. At d = 1587 they take
// 20.2 MB: 23 of the 3,176 rows (W's first 23) stay in shared memory beside
// 83 KB of vectors (228,672 of the 232,448 bytes), the other 3,153
// (20.0 MB) in the global slot, which with Cemp and H is 40.2 MB a block,
// 5.31 GB for 132 blocks, 106 times the L2: a round (794 pairs, thirteen
// pivot passes) moves about 1.44 times d = 1323's bytes. At d = 1875 they
// take 28.2 MB: 17 of the 3,752 rows (W's first 17) stay in shared memory
// beside 98 KB of vectors (225,120 of the 232,448 bytes), the other 3,735
// (28.0 MB) in the global slot, which with Cemp and H is 56.2 MB a block,
// 7.42 GB for 132 blocks, 148 times the L2: a round (938 pairs, fifteen
// pivot passes) moves about 1.4 times d = 1587's bytes. The design is the
// simple one, not tuned (its time beside its bound: PERF.md).
//
// The design:
//   - A persistent grid, at most one 512-thread block an SM (the wrapper
//     picks the count), each block looping over its share of the pixels
//     (`rows`).
//   - Each of the 2 (d + 1) rows of W and Q has a fixed home for the whole
//     pixel, row r in shared memory for r < RS and in the block's global
//     slot beyond (`Rows`); everything below addresses rows through it, so
//     the same code runs over either memory, whatever share of the rows
//     shared memory holds (at d = 363 to 675, none of Q).
//   - Re-seating by indirection: a round pairs seats (i, i + HALF); the
//     rows never move, a seat -> row map (`slot`, two buffers) is permuted
//     after each round instead. The pair state (diagonal estimates,
//     fast-Givens row scales) is kept by row.
//   - A round: eight lanes a pair form the inner products <W[a], Q[b]>
//     (16-byte loads, a three-step shuffle reduction; a warp takes four
//     pairs a pass, PASSES passes loaded together: two at d = 147 and 243,
//     three for the 182 pairs at d = 363, four for the 254 at d = 507, six
//     for the 338 at d = 675, seven for the 434 at d = 867, nine for the
//     542 at d = 1083, eleven for the 662 at d = 1323, thirteen for the
//     794 at d = 1587, fifteen for the 938 at d = 1875), lane k of a group
//     then forms the angles and row
//     scales of its pass-k pair and, from nine passes on, of its
//     pass-(k + 8) pair (as _jacobi_fp32 does), each pair's record
//     {alpha, beta, rows} and the next seat map; a barrier; every thread
//     rotates 16-byte units of the rows
//     of W and Q, one FMA an element; a barrier. At d = 243 a round is
//     bound by the L2 traffic of the global rows, not by their latency:
//     loading four units before storing any did not make it faster
//     (PERF.md).
//   - The parts of O(d^3) that run once a pixel are block-wide register-
//     tiled products (4 x 4 outputs a thread, at most NTP tiles a thread at
//     once, 16-byte operand rows, all of the form sum_k X[k][i] Y[k][j]):
//     M2, the clamp, H = Cemp A1^T, cov2 = A1 H and the filter. Cemp and H
//     live in the block's global scratch slot (2 (d + 1)^2 floats a block),
//     which the wrapper allocates with the global rows
//     (bcd_solve_filter_smem_scratch_floats sizes it). The Cholesky solves
//     reuse the space of W and Q once the clamp has read Q: right-looking,
//     one barrier a column, eps joining each pivot as it is reached (pivots
//     floored at 1e-30), the forward substitution taken along, the pivot
//     row kept in registers (d / 32 columns a lane) up to d = 507 and
//     staged in shared memory beyond, where the registers spilled it
//     (one more barrier a column; 28 columns a lane at d = 867, 34 at
//     d = 1083, 42 at d = 1323, 50 at d = 1587, 59 at d = 1875); the back
//     substitution right-looking too.
//
// Layouts (pixel-major, P pixels; bcd_tpu_torch/ops/solve_filter.py):
// cand (P, O, d), mask (P, O), noise (P, 6 npx) with the channels
// xx yy zz yz xz xy per patch pixel, n (P), m (P, d) -> field (P, O, d);
// with `rows`, pixels rows[0 .. n_rows) are solved and the other rows of
// field are left alone.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_FLOATS = 232448 / 4;  // shared memory a block may have

template <int D>
struct Smem {
  static constexpr int NPX = D / 3;
  static constexpr int NOV = 6 * NPX;
  static constexpr int DP = D + (D & 1);  // even size for the pairing
  static constexpr int HALF = DP / 2;     // a round rotates seats (i, i + HALF)
  static constexpr int Q4 = DP / 4;       // 16-byte units a row
  static constexpr int TRI = Q4 * (Q4 + 1) / 2;  // tiles on and below the diagonal
  static constexpr int THREADS = 512;
  static constexpr int WARPS = THREADS / 32;
  // a round's pivot products: four pairs a warp a pass, PASSES passes
  static constexpr int PPASS = 4 * WARPS;
  static constexpr int PASSES = (HALF + PPASS - 1) / PPASS;
  static constexpr int MAT = DP * DP;
  // tiles a thread accumulates at once in a block-wide product (16 floats
  // each), and in M2's (the candidates are staged again for each pass)
  static constexpr int NTP = 3;
  static constexpr int NTP_M2 = 2;
  static constexpr int M2_PASSES = (TRI + NTP_M2 * THREADS - 1) / (NTP_M2 * THREADS);
  // the Cholesky's pivot row of S and of Y, scaled: in registers, CL
  // columns a lane in each of two arrays, up to CL = 16 (d = 507); past
  // that (d = 675: 22 columns) ptxas spilled it inside the elimination
  // loop, so it is staged in the shared vectors instead (d = 675 to 1875;
  // 28 columns at 867, 34 at 1083, 42 at 1323, 50 at 1587, 59 at 1875). The
  // fields are the same bit for bit
  // either way; on an H100 the registers were the faster at d = 147 to 507
  // and the staged row at d = 675 and 867
  static constexpr int CL = (D + 31) / 32;
  static constexpr bool PIVOT_SMEM = CL > 16;
  // the vectors: m, the noise, diag, f, neg (then b2), the Cholesky's
  // 1 / L[j][j], a round's pair records {alpha, beta, top row, bottom row},
  // two seat maps (int) and, with PIVOT_SMEM, the staged pivot rows
  static constexpr int PIV = PIVOT_SMEM ? 2 * DP : 0;
  static constexpr int VEC = DP + (NOV + 3) / 4 * 4 + 4 * DP + 4 * HALF + 2 * DP + PIV;
  // rows of W (0 .. DP) and Q (DP .. 2 DP) in shared memory; the others
  // in the block's global slot (Rows)
  static constexpr int RS = (SMEM_FLOATS - VEC) / DP < 2 * DP ? (SMEM_FLOATS - VEC) / DP : 2 * DP;
  static constexpr int GROWS = 2 * DP - RS;
  // shared layout in floats: the shared rows, then the vectors
  static constexpr int M_OFF = RS * DP;
  static constexpr int NOV_OFF = M_OFF + DP;
  static constexpr int DIAG_OFF = NOV_OFF + (NOV + 3) / 4 * 4;
  static constexpr int F_OFF = DIAG_OFF + DP;
  static constexpr int NEG_OFF = F_OFF + DP;  // then b2
  static constexpr int R_OFF = NEG_OFF + DP;  // the Cholesky's 1 / L[j][j]
  static constexpr int REC_OFF = R_OFF + DP;
  static constexpr int SLOT_OFF = REC_OFF + 4 * HALF;
  static constexpr int PIV_OFF = SLOT_OFF + 2 * DP;
  static constexpr int FLOATS = PIV_OFF + PIV;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
  // global floats a block: Cemp, H, then the rows not in shared memory
  static constexpr int SCRATCH = 2 * MAT + GROWS * DP;
  static_assert(FLOATS == M_OFF + VEC, "the vectors' layout");
  static_assert(DP % 4 == 0 && REC_OFF % 4 == 0, "rows of 16-byte units");
  // every lane's first pair is a real one, and a group's eight lanes form
  // the angles of all its passes' pairs, a lane those of at most two
  // passes (k and k + 8): up to d = 2,048, patch radius 12
  static_assert(PPASS <= HALF && PASSES <= 16, "a round's pairs in one to sixteen passes");
  static_assert(BYTES <= 4 * SMEM_FLOATS, "more shared memory than a block may have");
};

// row r of W (r < DP) or Q (DP + r): in shared memory below RS, else in
// the block's global slot
template <int D>
struct Rows {
  float* s;
  float* g;
  __device__ __forceinline__ float* operator()(int r) const {
    using G = Smem<D>;
    if constexpr (G::GROWS == 0) {
      return s + r * G::DP;
    } else {
      return r < G::RS ? s + r * G::DP : g + (r - G::RS) * G::DP;
    }
  }
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

// Brent-Luk re-seating after a round: the new seat of old seat `s` (seats
// [U0, D0, U1..U(h-2), D1..D(h-1), U(h-1)] with U_i seat i and D_i seat
// i + h; the inverse of ops/solve_filter.reseat_order)
template <int DP>
__device__ __forceinline__ int to_seat(int s) {
  constexpr int H = DP / 2;
  return s == 0 ? 0 : s == H ? 1 : s < H - 1 ? s + 1 : s == H - 1 ? DP - 1 : s - 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the lower-triangle tile t (row ti >= column tj) of a grid of tiles
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

__device__ __forceinline__ float4 ld4(const float* p, bool global) {
  return global ? __ldcg(reinterpret_cast<const float4*>(p))
                : *reinterpret_cast<const float4*>(p);
}

// Block-wide product acc(i, j) = sum_{k < kn} X(k)[i] Y(k)[j] over 4 x 4
// tiles: X(k) and Y(k) give row k (DP floats) of each operand, in shared
// memory or the global rows (Rows) or (flag set) the block's global
// scratch, read past L1. Tiles go to threads tid, tid + 512, ..., NTP at a
// time: all rows4 x Q4 of them, or with `lower` those with ti >= tj
// (tri_tile). `skip(k)` (uniform over the block) leaves a k out; `xs(k)`
// scales row k of X. epi(i0, j0, acc) stores a tile; it must not write
// what X or Y read.
template <int D, class XRow, class YRow, class Skip, class XScale, class Epi>
__device__ __forceinline__ void tile_product(XRow X, bool xg, YRow Y, bool yg, int kn,
                                             bool lower, int rows4, Skip skip, XScale xs,
                                             Epi epi) {
  using G = Smem<D>;
  constexpr int NT = G::NTP;
  const int n_tiles = lower ? G::TRI : rows4 * G::Q4;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int t0 = tid; t0 < n_tiles; t0 += NT * G::THREADS) {
    int ti[NT], tj[NT];
    float acc[NT][16];
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int t = t0 + u * G::THREADS;
      ti[u] = tj[u] = 0;
      if (t < n_tiles) {
        if (lower) {
          tri_tile(t, ti[u], tj[u]);
        } else {
          ti[u] = t / G::Q4;
          tj[u] = t - ti[u] * G::Q4;
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[u][e] = 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < kn; ++k) {
      if (skip(k)) continue;
      const float s = xs(k);
      const float* xk = X(k);
      const float* yk = Y(k);
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        if (t0 + u * G::THREADS < n_tiles) {
          const float4 a = ld4(xk + 4 * ti[u], xg);
          const float4 b = ld4(yk + 4 * tj[u], yg);
          const float av[4] = {a.x * s, a.y * s, a.z * s, a.w * s};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[u][4 * p + q] = fmaf(av[p], bv[q], acc[u][4 * p + q]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NT; ++u)
      if (t0 + u * G::THREADS < n_tiles) epi(4 * ti[u], 4 * tj[u], acc[u]);
  }
}

// X = (S + eps I)^-1 BD for S (symmetric, rows S(i) of DP floats), the
// right-hand sides in rows Y(i) (set here to BD, ending as X).
// Right-looking, one barrier a column: at step j every thread forms
// r_j = 1 / L[j][j] from the pivot, rows i > j of the trailing matrix (on
// and above the diagonal; S stays symmetric, so row j is column j) and of
// Y take L[i][j] = S[j][i] r_j times row j, scaled by r_j. Row j of Y is
// scaled in place at step j + 1, when nobody reads it. The back
// substitution goes up, right-looking: at step i row i of X is final, and
// rows l < i take L[i][l] X[i]. The scaled pivot rows sit in registers
// (CL columns a lane) or, with PIVOT_SMEM, in `pv` (2 DP floats of shared
// memory, one more barrier a step); the arithmetic is the same. Ends with
// a block barrier.
template <int D, class SRow, class YRow>
__device__ __forceinline__ void chol_solve(SRow S, YRow Y, const float* nov, float* rv,
                                           float* pv, float eps) {
  using G = Smem<D>;
  constexpr int DP = G::DP;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int e = tid; e < DP * DP; e += G::THREADS) {
    const int i = e / DP, c = e - i * DP;
    Y(i)[c] = (i < D && c < D) ? bd_at(nov, i, c) : 0.f;
  }
  constexpr int CL = G::CL;  // columns a lane: c = lane + 32 m
#pragma unroll 1
  for (int j = 0; j < D; ++j) {
    __syncthreads();
    const float* sj = S(j);
    const float rj = 1.f / sqrtf(fmaxf(sj[j] + eps, 1e-30f));
    if (tid == 0) rv[j] = rj;
    if (j > 0 && warp == G::WARPS - 1) {
      const float rp = rv[j - 1];
      float* yp = Y(j - 1);
      for (int c = lane; c < D; c += 32) yp[c] *= rp;
    }
    // row j of S (= column j) and of Y, scaled by r_j
    const float* yj = Y(j);
    if constexpr (G::PIVOT_SMEM) {
      for (int c = tid; c < D; c += G::THREADS) {
        pv[c] = sj[c] * rj;
        pv[DP + c] = yj[c] * rj;
      }
      __syncthreads();
      for (int i = j + 1 + warp; i < D; i += G::WARPS) {
        const float lij = pv[i];
        float* si = S(i);
        float* yi = Y(i);
        for (int c = lane; c < D; c += 32) {
          if (c >= i) si[c] = fmaf(-lij, pv[c], si[c]);
          yi[c] = fmaf(-lij, pv[DP + c], yi[c]);
        }
      }
    } else {
      float sr[CL], yr[CL];
#pragma unroll
      for (int mm = 0; mm < CL; ++mm) {
        const int c = lane + 32 * mm;
        sr[mm] = c < D ? sj[c] * rj : 0.f;
        yr[mm] = c < D ? yj[c] * rj : 0.f;
      }
      for (int i = j + 1 + warp; i < D; i += G::WARPS) {
        const float lij = sj[i] * rj;
        float* si = S(i);
        float* yi = Y(i);
#pragma unroll
        for (int mm = 0; mm < CL; ++mm) {
          const int c = lane + 32 * mm;
          if (c >= i && c < D) si[c] = fmaf(-lij, sr[mm], si[c]);
          if (c < D) yi[c] = fmaf(-lij, yr[mm], yi[c]);
        }
      }
    }
  }
  __syncthreads();
  if (warp == G::WARPS - 1) {
    const float rp = rv[D - 1];
    float* yp = Y(D - 1);
    for (int c = lane; c < D; c += 32) yp[c] *= rp;
  }
  // back substitution: X[i] = (Y[i] - sum_{k > i} L[k][i] X[k]) r_i, with
  // L[k][i] = S[i][k] r_i; step i scales row i (final) and updates rows
  // l < i by L[i][l] X[i]
#pragma unroll 1
  for (int i = D - 1; i >= 0; --i) {
    __syncthreads();
    const float ri = rv[i];
    if (i < D - 1 && warp == G::WARPS - 1) {
      const float rn = rv[i + 1];
      float* yn = Y(i + 1);
      for (int c = lane; c < D; c += 32) yn[c] *= rn;
    }
    const float* yi = Y(i);
    if constexpr (G::PIVOT_SMEM) {
      for (int c = tid; c < D; c += G::THREADS) pv[c] = yi[c] * ri;
      __syncthreads();
      for (int l = warp; l < i; l += G::WARPS) {
        const float lil = S(l)[i] * rv[l];
        float* yl = Y(l);
        for (int c = lane; c < D; c += 32) yl[c] = fmaf(-lil, pv[c], yl[c]);
      }
    } else {
      float xr[CL];
#pragma unroll
      for (int mm = 0; mm < CL; ++mm) {
        const int c = lane + 32 * mm;
        xr[mm] = c < D ? yi[c] * ri : 0.f;
      }
      for (int l = warp; l < i; l += G::WARPS) {
        const float lil = S(l)[i] * rv[l];
        float* yl = Y(l);
#pragma unroll
        for (int mm = 0; mm < CL; ++mm) {
          const int c = lane + 32 * mm;
          if (c < D) yl[c] = fmaf(-lil, xr[mm], yl[c]);
        }
      }
    }
  }
  __syncthreads();
  if (warp == G::WARPS - 1) {
    const float r0 = rv[0];
    float* y0 = Y(0);
    for (int c = lane; c < D; c += 32) y0[c] *= r0;
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(Smem<D>::THREADS, 1)
solve_filter_smem_kernel(const float* __restrict__ cand, const float* __restrict__ mask,
                         const float* __restrict__ noise, const float* __restrict__ n_in,
                         const float* __restrict__ m_in, const int* __restrict__ rows,
                         float eps, int n_rows, int n_off, int sweeps, float* scratch,
                         float* __restrict__ field) {
  using G = Smem<D>;
  constexpr int DP = G::DP, HALF = G::HALF, Q4 = G::Q4, T = G::THREADS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* mv = sm + G::M_OFF;
  float* nov = sm + G::NOV_OFF;
  float* diag = sm + G::DIAG_OFF;
  float* fsc = sm + G::F_OFF;
  float* neg = sm + G::NEG_OFF;
  float* rv = sm + G::R_OFF;
  float4* rec = reinterpret_cast<float4*>(sm + G::REC_OFF);
  int* slot = reinterpret_cast<int*>(sm + G::SLOT_OFF);
  float* pv = sm + G::PIV_OFF;
  float* cemp = scratch + (size_t)blockIdx.x * G::SCRATCH;  // global, row stride DP
  float* hmat = cemp + G::MAT;
  const Rows<D> row{sm, hmat + G::MAT};
  auto W = [&](int i) { return row(i); };       // W; candidates; S; Ct
  auto Q = [&](int i) { return row(DP + i); };  // Q; weighted candidates; Y
  auto cemp_row = [&](int k) { return cemp + k * DP; };
  auto hmat_row = [&](int k) { return hmat + k * DP; };
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  auto none = [](int) { return false; };
  auto one = [](int) { return 1.f; };

#pragma unroll 1
  for (int q = blockIdx.x; q < n_rows; q += gridDim.x) {
    const size_t p = rows ? rows[q] : q;
    const float* cp = cand + p * n_off * D;
    const float* wp = mask + p * n_off;
    float* fp = field + p * n_off * D;
    const float n = n_in[p];
    __syncthreads();  // the previous pixel is done with every buffer
    for (int i = tid; i < DP; i += T) mv[i] = i < D ? m_in[p * D + i] : 0.f;
    for (int i = tid; i < G::NOV; i += T) nov[i] = noise[p * G::NOV + i];

    // M2 = sum_o (w_o c_o) c_o^T over chunks of DP candidates (W rows: c_o,
    // Q rows: w_o c_o), NTP_M2 lower tiles a thread a pass; Cemp to the
    // scratch, mirrored from the lower tiles; then W = Cemp - BD, Q = I
    {
      constexpr int NT = G::NTP_M2;
      const float nm1 = fmaxf(n - 1.f, 1.f);
#pragma unroll 1
      for (int pass = 0; pass < G::M2_PASSES; ++pass) {  // uniform: it holds barriers
        const int t0 = tid + pass * NT * T;
        int ti[NT], tj[NT];
        float acc[NT][16];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          ti[u] = tj[u] = 0;
          if (t0 + u * T < G::TRI) tri_tile(t0 + u * T, ti[u], tj[u]);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[u][e] = 0.f;
        }
#pragma unroll 1
        for (int o0 = 0; o0 < n_off; o0 += DP) {
          const int cnt = min(DP, n_off - o0);
          __syncthreads();
          for (int e = tid; e < cnt * DP; e += T) {
            const int o = e / DP, i = e - o * DP;
            const float c = i < D ? cp[(size_t)(o0 + o) * D + i] : 0.f;
            W(o)[i] = c;
            Q(o)[i] = wp[o0 + o] * c;
          }
          __syncthreads();
#pragma unroll 1
          for (int o = 0; o < cnt; ++o) {
            const float* qo = Q(o);
            const float* wo = W(o);
#pragma unroll
            for (int u = 0; u < NT; ++u) {
              if (t0 + u * T < G::TRI) {
                const float4 a = *reinterpret_cast<const float4*>(qo + 4 * ti[u]);
                const float4 b = *reinterpret_cast<const float4*>(wo + 4 * tj[u]);
                const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                  for (int s = 0; s < 4; ++s)
                    acc[u][4 * r + s] = fmaf(av[r], bv[s], acc[u][4 * r + s]);
              }
            }
          }
        }
        __syncthreads();  // every thread is done with the candidates
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          if (t0 + u * T >= G::TRI) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int i = 4 * ti[u] + r, j = 4 * tj[u] + s;
              if (j > i) continue;  // the upper half of a diagonal tile
              const float ce =
                  (i < D && j < D) ? (acc[u][4 * r + s] - n * mv[i] * mv[j]) / nm1 : 0.f;
              cemp[i * DP + j] = ce;
              cemp[j * DP + i] = ce;
            }
        }
      }
      __syncthreads();  // Cemp is whole
      for (int e = tid; e < DP * DP; e += T) {
        const int i = e / DP, j = e - i * DP;
        W(i)[j] = (i < D && j < D) ? __ldcg(cemp + e) - bd_at(nov, i, j) : 0.f;
      }
      for (int e = tid; e < DP * DP; e += T) {
        const int i = e / DP, c = e - i * DP;
        Q(i)[c] = i == c ? 1.f : 0.f;
      }
      for (int i = tid; i < DP; i += T) {
        slot[i] = i;
        fsc[i] = 1.f;
      }
      __syncthreads();
      for (int i = tid; i < DP; i += T) diag[i] = W(i)[i];
    }

    // the Jacobi: rows W(r), Q(r) by physical row r; seat s is row
    // slot[buf][s]
    int buf = 0;
#pragma unroll 1
    for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll 1
      for (int r = 0; r < DP - 1; ++r) {
        __syncthreads();
        const int* cur = slot + buf * DP;
        int* nxt = slot + (1 - buf) * DP;
        // pivots <W[a], Q[b]> of the pairs (a, b) = (cur[i], cur[i + HALF]):
        // eight lanes a pair, pairs p0 + k PPASS (pass k), p0 = 4 warp + g,
        // where g is the lane's group; each lane sums columns 4 (sub + 8 m)
        constexpr int NP = G::PASSES;
        const int g = lane / 8, sub = lane % 8;
        const int p0 = 4 * warp + g;
        float sp[NP];
        {
          const float4* wv[NP];
          const float4* qv[NP];
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int pk = p0 + k * G::PPASS;
            const int pc = pk < HALF ? pk : p0;
            wv[k] = reinterpret_cast<const float4*>(W(cur[pc]));
            qv[k] = reinterpret_cast<const float4*>(Q(cur[pc + HALF]));
            sp[k] = 0.f;
          }
#pragma unroll
          for (int mm = 0; mm < (Q4 + 7) / 8; ++mm) {
            const int c4 = sub + 8 * mm;
            if (c4 < Q4) {
#pragma unroll
              for (int k = 0; k < NP; ++k) {
                if (k == 0 || p0 + k * G::PPASS < HALF) {
                  const float4 a = wv[k][c4], b = qv[k][c4];
                  sp[k] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, sp[k]))));
                }
              }
            }
          }
#pragma unroll
          for (int o = 4; o >= 1; o /= 2)
#pragma unroll
            for (int k = 0; k < NP; ++k) sp[k] += __shfl_xor_sync(FULL, sp[k], o);
        }
        // lane k of a group forms the angles of its pass-k pair and, from
        // nine passes on (d = 1083; lanes 0-2 at d = 1323's eleven, 0-4 at
        // d = 1587's thirteen, 0-6 at d = 1875's fifteen), of its
        // pass-(k + 8) pair: a round's
        // pairs are disjoint, so one lane's two pairs write disjoint diag,
        // fsc, rec and nxt entries. Up to eight passes the step is the one
        // the smaller d were timed with, so they compile to the same code
        if constexpr (NP <= 8) {
          const int i = p0 + sub * G::PPASS;
          if (sub < NP && i < HALF) {
            float sum = sp[0];
#pragma unroll
            for (int k = 1; k < NP; ++k)
              if (sub == k) sum = sp[k];
            const int ra = cur[i], rb = cur[i + HALF];
            const float app = diag[ra], aqq = diag[rb];
            const float fp_ = fsc[ra], fq = fsc[rb];
            const float apq = sum * (fp_ * fq);
            const bool small = fabsf(apq) < 1e-30f;
            const float tau = (aqq - app) / (small ? 1.f : 2.f * apq);
            float tt = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
            if (tau == 0.f) tt = 1.f;
            if (small) tt = 0.f;
            const float cs = 1.f / sqrtf(1.f + tt * tt);
            const float sn = tt * cs;
            const float inv_cf = 1.f / (cs * fp_ * fq);
            const float tapq = tt * apq;
            rec[i] = make_float4(small ? 0.f : -sn * fq * fq * inv_cf,
                                 small ? 0.f : sn * fp_ * fp_ * inv_cf, __int_as_float(ra),
                                 __int_as_float(rb));
            diag[ra] = app - tapq;
            diag[rb] = aqq + tapq;
            fsc[ra] = cs * fp_;
            fsc[rb] = cs * fq;
            nxt[to_seat<DP>(i)] = ra;
            nxt[to_seat<DP>(i + HALF)] = rb;
          }
        } else {
#pragma unroll
          for (int t8 = 0; t8 < (NP + 7) / 8; ++t8) {
            const int k = sub + 8 * t8;
            const int i = p0 + k * G::PPASS;
            if (k < NP && i < HALF) {
              float sum = sp[0];
#pragma unroll
              for (int kk = 1; kk < NP; ++kk)
                if (k == kk) sum = sp[kk];
              const int ra = cur[i], rb = cur[i + HALF];
              const float app = diag[ra], aqq = diag[rb];
              const float fp_ = fsc[ra], fq = fsc[rb];
              const float apq = sum * (fp_ * fq);
              const bool small = fabsf(apq) < 1e-30f;
              const float tau = (aqq - app) / (small ? 1.f : 2.f * apq);
              float tt = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
              if (tau == 0.f) tt = 1.f;
              if (small) tt = 0.f;
              const float cs = 1.f / sqrtf(1.f + tt * tt);
              const float sn = tt * cs;
              const float inv_cf = 1.f / (cs * fp_ * fq);
              const float tapq = tt * apq;
              rec[i] = make_float4(small ? 0.f : -sn * fq * fq * inv_cf,
                                   small ? 0.f : sn * fp_ * fp_ * inv_cf, __int_as_float(ra),
                                   __int_as_float(rb));
              diag[ra] = app - tapq;
              diag[rb] = aqq + tapq;
              fsc[ra] = cs * fp_;
              fsc[rb] = cs * fq;
              nxt[to_seat<DP>(i)] = ra;
              nxt[to_seat<DP>(i + HALF)] = rb;
            }
          }
        }
        __syncthreads();
        // fast-Givens rows: top' = top + alpha bot, bot' = beta top + bot,
        // 16-byte unit u of the pair record's rows of W (u < HALF Q4) or Q
#pragma unroll 1
        for (int u = tid; u < 2 * HALF * Q4; u += T) {
          const bool qm = u >= HALF * Q4;
          const int v = qm ? u - HALF * Q4 : u;
          const int pi = v / Q4, c4 = v - pi * Q4;
          const float4 rc = rec[pi];
          const int base = qm ? DP : 0;
          float4* top = reinterpret_cast<float4*>(row(base + __float_as_int(rc.z))) + c4;
          float4* bot = reinterpret_cast<float4*>(row(base + __float_as_int(rc.w))) + c4;
          const float a = rc.x, b = rc.y;
          const float4 x = *top, y = *bot;
          *top = make_float4(fmaf(a, y.x, x.x), fmaf(a, y.y, x.y), fmaf(a, y.z, x.z),
                             fmaf(a, y.w, x.w));
          *bot = make_float4(fmaf(b, x.x, y.x), fmaf(b, x.y, y.y), fmaf(b, x.z, y.z),
                             fmaf(b, x.w, y.w));
        }
        buf = 1 - buf;
      }
      // renormalize: fold the row scales into the rows
      __syncthreads();
      for (int u = tid; u < 2 * DP * Q4; u += T) {
        const int r = u / Q4;  // W rows, then Q rows
        float4* x = reinterpret_cast<float4*>(row(r)) + (u - r * Q4);
        const float f = fsc[r < DP ? r : r - DP];
        const float4 y = *x;
        *x = make_float4(y.x * f, y.y * f, y.z * f, y.w * f);
      }
      __syncthreads();
      for (int i = tid; i < DP; i += T) fsc[i] = 1.f;
    }
    // exact eigenvalues lam_a = <W[a], Q[a]> by row; the negative ones
    __syncthreads();
    for (int a = warp; a < DP; a += G::WARPS) {
      const float* wa = W(a);
      const float* qa = Q(a);
      float s = 0.f;
      for (int k = lane; k < DP; k += 32) s = fmaf(wa[k], qa[k], s);
      s = warp_sum(s);
      if (lane == 0) neg[a] = fmaxf(-s, 0.f);
    }
    __syncthreads();

    // step 1: S1 = Cemp + sum_a neg_a q_a q_a^T (lower tiles, mirrored) to
    // W, over the rows with a negative eigenvalue
    tile_product<D>(
        Q, false, Q, false, DP, true, Q4, [&](int k) { return neg[k] == 0.f; },
        [&](int k) { return neg[k]; },
        [&](int i0, int j0, const float* acc) {
          for (int r = 0; r < 4; ++r)
            for (int s = 0; s < 4; ++s) {
              const int i = i0 + r, j = j0 + s;
              if (j > i) continue;
              const float v = (i < D && j < D) ? __ldcg(cemp + i * DP + j) + acc[4 * r + s] : 0.f;
              W(i)[j] = v;
              W(j)[i] = v;
            }
        });
    __syncthreads();  // every thread has read Q before the solve writes it
    chol_solve<D>(W, Q, nov, rv, pv, eps);  // Q rows: X1
    // A1^T = I - X1 in place; H = Cemp A1^T to the scratch (Cemp is
    // symmetric: H[i][c] = sum_k Cemp[k][i] A1^T[k][c])
    for (int e = tid; e < DP * DP; e += T) {
      const int i = e / DP, c = e - i * DP;
      float* qi = Q(i);
      qi[c] = (i < D && c < D) ? (i == c ? 1.f : 0.f) - qi[c] : 0.f;
    }
    __syncthreads();
    tile_product<D>(cemp_row, true, Q, false, D, false, Q4, none, one,
                    [&](int i0, int j0, const float* acc) {
                      for (int r = 0; r < 4; ++r) {
                        float* h = hmat + (i0 + r) * DP + j0;
                        *reinterpret_cast<float4*>(h) =
                            make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2], acc[4 * r + 3]);
                      }
                    });
    __syncthreads();
    // S2 = A1 H + BD (cov2[i][j] = sum_k A1^T[k][i] H[k][j]; lower tiles,
    // mirrored) to W
    tile_product<D>(Q, false, hmat_row, true, D, true, Q4, none, one,
                    [&](int i0, int j0, const float* acc) {
                      for (int r = 0; r < 4; ++r)
                        for (int s = 0; s < 4; ++s) {
                          const int i = i0 + r, j = j0 + s;
                          if (j > i) continue;
                          const float v = (i < D && j < D) ? acc[4 * r + s] + bd_at(nov, i, j) : 0.f;
                          W(i)[j] = v;
                          W(j)[i] = v;
                        }
                    });
    __syncthreads();  // every thread has read A1^T before the solve writes Q
    chol_solve<D>(W, Q, nov, rv, pv, eps);  // Q rows: X2
    // b2[c] = sum_k X2[k][c] m[k]
    for (int c = tid; c < DP; c += T) {
      float s = 0.f;
      if (c < D)
        for (int k = 0; k < D; ++k) s = fmaf(Q(k)[c], mv[k], s);
      neg[c] = s;
    }

    // field_o = mask_o (c_o - X2^T c_o + b2): candidates staged transposed
    // in the W rows (Ct[k][o]) in chunks of DP
#pragma unroll 1
    for (int o0 = 0; o0 < n_off; o0 += DP) {
      const int cnt = min(DP, n_off - o0);
      __syncthreads();
      for (int e = tid; e < DP * DP; e += T) {
        const int o = e / DP, k = e - o * DP;
        W(k)[o] = (o < cnt && k < D) ? cp[(size_t)(o0 + o) * D + k] : 0.f;
      }
      __syncthreads();
      tile_product<D>(W, false, Q, false, D, false, (cnt + 3) / 4, none, one,
                      [&](int i0, int j0, const float* acc) {
                        for (int r = 0; r < 4; ++r) {
                          const int o = i0 + r;
                          if (o >= cnt) continue;
                          const float w = wp[o0 + o];
                          for (int s = 0; s < 4; ++s) {
                            const int j = j0 + s;
                            if (j >= D) continue;
                            float out = 0.f;
                            if (w != 0.f) out = (W(j)[o] - acc[4 * r + s] + neg[j]) * w;
                            fp[(size_t)(o0 + o) * D + j] = out;
                          }
                        }
                      });
    }
  }
}

}  // namespace

// The library's build compiles this file once for each d (-DBCD_SMEM_D=d:
// that instance of the kernel and its launch) and once for the C entries
// below (-DBCD_SMEM_ENTRIES), all at once (ops/_build.py): in one
// translation unit the instances compile one after another. With neither
// macro the file is one translation unit, as ops/sass_check.py compiles it.
// launch<D> has external linkage, so that the entries can call an instance
// compiled in another unit.
namespace bcd_smem {

template <int D>
int launch(const float* cand, const float* mask, const float* noise, const float* n,
           const float* m, const int* rows, float eps, int n_rows, int n_off, int sweeps,
           float* scratch, int n_blocks, float* field, cudaStream_t stream)
#ifdef BCD_SMEM_ENTRIES
    ;  // each instance is compiled in a unit of its own
#else
{
  using G = Smem<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_filter_smem_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  solve_filter_smem_kernel<D><<<n_blocks, G::THREADS, G::BYTES, stream>>>(
      cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch, field);
  return (int)cudaGetLastError();
}
#endif

}  // namespace bcd_smem

#ifdef BCD_SMEM_D
template int bcd_smem::launch<BCD_SMEM_D>(const float*, const float*, const float*,
                                          const float*, const float*, const int*, float,
                                          int, int, int, float*, int, float*,
                                          cudaStream_t);
#else

// floats of global scratch the kernel needs for `n_blocks` blocks at patch
// dimension d, a 64-bit count (132 blocks pass 2^31 floats from d = 2187);
// -1 for a d it is not built for
extern "C" long long bcd_solve_filter_smem_scratch_floats(int d, int n_blocks) {
  if (n_blocks < 0) return -1;
  const long long nb = n_blocks;
  if (d == 147) return nb * Smem<147>::SCRATCH;
  if (d == 243) return nb * Smem<243>::SCRATCH;
  if (d == 363) return nb * Smem<363>::SCRATCH;
  if (d == 507) return nb * Smem<507>::SCRATCH;
  if (d == 675) return nb * Smem<675>::SCRATCH;
  if (d == 867) return nb * Smem<867>::SCRATCH;
  if (d == 1083) return nb * Smem<1083>::SCRATCH;
  if (d == 1323) return nb * Smem<1323>::SCRATCH;
  if (d == 1587) return nb * Smem<1587>::SCRATCH;
  if (d == 1875) return nb * Smem<1875>::SCRATCH;
  return -1;
}

extern "C" int bcd_solve_filter_smem(const float* cand, const float* mask,
                                     const float* noise, const float* n,
                                     const float* m, const int* rows, float eps,
                                     int n_rows, int n_off, int d, int sweeps,
                                     float* scratch, int n_blocks, float* field,
                                     void* stream) {
  if ((d != 147 && d != 243 && d != 363 && d != 507 && d != 675 && d != 867 &&
       d != 1083 && d != 1323 && d != 1587 && d != 1875) ||
      n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  using bcd_smem::launch;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 147)
    return launch<147>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                       n_blocks, field, st);
  if (d == 243)
    return launch<243>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                       n_blocks, field, st);
  if (d == 363)
    return launch<363>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                       n_blocks, field, st);
  if (d == 507)
    return launch<507>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                       n_blocks, field, st);
  if (d == 675)
    return launch<675>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                       n_blocks, field, st);
  if (d == 867)
    return launch<867>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                       n_blocks, field, st);
  if (d == 1083)
    return launch<1083>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                        n_blocks, field, st);
  if (d == 1323)
    return launch<1323>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                        n_blocks, field, st);
  if (d == 1587)
    return launch<1587>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                        n_blocks, field, st);
  return launch<1875>(cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch,
                      n_blocks, field, st);
}
#endif
