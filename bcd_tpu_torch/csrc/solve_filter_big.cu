// solve_filter at any patch dimension d, a runtime argument: the kernel the
// engine runs from patch radius 13 (d = 2187) on, at every larger radius.
// It computes what csrc/solve_filter_smem.cu computes at d = 147 to 1875,
// with the same algorithm and the same arithmetic a pair, so that the same
// fp32 model holds both (ops/solve_filter.py::solve_filter_pm_schedule,
// whose Jacobi _jacobi_fp32 is a function of d).
//
// Replaces bcd_tpu/ops/solve_filter_pallas.py::solve_filter (TPU kernel
// body _solve_filter_kernel, Jacobi _jacobi_clamp_psd) at d >= 2187. Per
// pixel:
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
//
// The same kernel, instanced with kMoments, is the lane solve_matrices at
// every d (replacing bcd_tpu/ops/solve_filter_pallas.py::solve_matrices,
// core _two_step_solve, at d >= 147; d = 27 and 75 run csrc/solve_filter.cu):
// its front reads M2 (as given, not mirrored), the patch sums and the noise
// sums, and forms m = msum / max(n, 1), the mean noise and Cemp from them;
// its back writes A2^T = I - X2 and b2 = X2^T m in place of the field. The
// Jacobi, the clamp and both Cholesky solves are the same code, so the same
// fp32 model holds it (ops/solve_filter.py::solve_matrices_schedule).
//
// Why d is a runtime value here. solve_filter_smem.cu's Smem<D> fixes d,
// the rows shared memory holds and a round's pivot passes at compile
// time, and loads all of a round's passes together: at most sixteen
// passes (d <= 2,048), and from d = 1323 the pass loop's row pointers
// spill. Above d = 2,048 shared memory holds only a handful of the
// 2 (d + 1) rows of W and Q (13 of 4,376 at d = 2187), so a compile-time d
// buys little there. Here every size is computed once a launch (Layout)
// and passed by value:
//   - The pivot products of a round are formed in chunks of eight passes,
//     a loop over chunks; right after its chunk, lane k of a group forms
//     the angles of its pass-(c + k) pair, so at d = 2187 (18 passes) a
//     lane forms those of passes k, k + 8 and k + 16. A pair's sum, its
//     shuffle reduction and its angle step are the instances' arithmetic,
//     so at d = 147 this kernel gives Smem<147>'s bits.
//   - Shared memory holds the vectors first, in the order m, the noise,
//     diag, f, neg (then b2), 1 / L[j][j], the two seat maps, the pair
//     records, the staged Cholesky rows, as many of them as fit: all of
//     them through d = 4,107 (patch radius 18); from d = 4,563 (radius 19)
//     the staged rows move to the block's global slot, then the records,
//     and so on. Then as many rows of W and Q as the rest of it holds;
//     every other row is in the global slot. Every row and vector is
//     addressed through one pointer set a launch, so the same code runs
//     over either memory.
//   - Counts of elements of a (d + 1)^2 matrix, row offsets and stack
//     offsets are 64-bit (or unsigned where a loop is hot: up to
//     d + 1 = 131,070, where one block's slot alone takes 275 GB); at
//     d = 2187 a block's slot holds 19,120,932 floats and 132 blocks
//     2,523,963,024, past 2^31.
//
// What bounds it on an H100: as for Smem<1875> (PERF.md), a round reads
// and writes the global rows of W and Q (4,363 of 4,376 at d = 2187, about
// 38 MB a block) and reads the pivot rows again, nearly all from HBM; a
// call on a few pixels is bound by one block's latency. The design is the
// simple one, not tuned.
//
// The design otherwise is solve_filter_smem.cu's: a persistent grid of
// 512-thread blocks, one an SM at most (the wrapper picks the count from
// the SMs, the rows and the card's free memory), each looping over its
// share of the pixels (`rows`); re-seating by indirection through a
// seat -> row map; eight lanes a pair for the pivot products; the
// rotations in 16-byte units; the O(d^3) parts that run once a pixel as
// block-wide register-tiled products (4 x 4 outputs a thread, NTP tiles at
// once); Cemp and H in the block's global slot; right-looking Cholesky
// solves, one barrier a column, the pivot row staged in the vectors.
//
// Layouts (pixel-major, P pixels; bcd_tpu_torch/ops/solve_filter.py):
// cand (P, O, d), mask (P, O), noise (P, 6 npx) with the channels
// xx yy zz yz xz xy per patch pixel, n (P), m (P, d) -> field (P, O, d);
// with `rows`, pixels rows[0 .. n_rows) are solved and the other rows of
// field are left alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_FLOATS = 232448 / 4;  // shared memory a block may have
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PPASS = 4 * WARPS;  // a pass's pivot products: four pairs a warp
constexpr int CHUNK = 8;          // passes whose pivot products are formed at once
constexpr int NTP = 3;            // tiles a thread accumulates in a block-wide product
constexpr int NTP_M2 = 2;         // ... and in M2's

// the vectors, in the order they take shared memory
enum { V_M, V_NOV, V_DIAG, V_F, V_NEG, V_R, V_SLOT, V_REC, V_PIV, N_VEC };

struct Layout {
  int d, nov, dp, half, q4, tri, passes, m2_passes;
  int vec_shared;  // vectors [0, vec_shared) in shared memory, the rest global
  int rs;          // rows of W and Q in shared memory (the first rs)
  int grows;       // rows in the block's global slot
  int smem_floats;
  long long off[N_VEC];  // floats from the shared vectors' or the global vectors' start
  long long gvec;        // floats of vectors in the global slot
  long long scratch;     // global floats a block: Cemp, H, the global rows and vectors
};

// false for a d the kernel cannot lay out (d % 3 != 0 or d + (d & 1) not a
// multiple of 4, which no patch dimension 3 (2r + 1)^2 is)
__host__ __device__ inline bool make_layout(int d, Layout* L) {
  if (d < 3 || d % 3 != 0 || d > 131067) return false;
  const int dp = d + (d & 1);
  if (dp % 4 != 0) return false;
  L->d = d;
  L->nov = 6 * (d / 3);
  L->dp = dp;
  L->half = dp / 2;
  L->q4 = dp / 4;
  L->tri = L->q4 * (L->q4 + 1) / 2;
  L->passes = (L->half + PPASS - 1) / PPASS;
  L->m2_passes = (L->tri + NTP_M2 * THREADS - 1) / (NTP_M2 * THREADS);
  const long long size[N_VEC] = {dp, (L->nov + 3) / 4 * 4, dp, dp, dp, dp, 2LL * dp,
                                 2LL * dp, 2LL * dp};
  long long shared = 0, global = 0;
  int k = 0;
  for (; k < N_VEC && shared + size[k] <= SMEM_FLOATS; ++k) {
    L->off[k] = shared;
    shared += size[k];
  }
  L->vec_shared = k;
  for (; k < N_VEC; ++k) {
    L->off[k] = global;
    global += size[k];
  }
  const long long rows = (SMEM_FLOATS - shared) / dp;
  L->rs = (int)(rows < 2LL * dp ? rows : 2LL * dp);
  L->grows = 2 * dp - L->rs;
  L->smem_floats = (int)((long long)L->rs * dp + shared);
  L->gvec = global;
  L->scratch = 2LL * dp * dp + (long long)L->grows * dp + global;
  return true;
}

// row r of W (r < dp) or Q (dp + r): in shared memory below rs, else in
// the block's global slot
struct Rows {
  float* s;
  float* g;
  int rs, dp;
  __device__ __forceinline__ float* operator()(int r) const {
    return r < rs ? s + (size_t)r * dp : g + (size_t)(r - rs) * dp;
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

// Brent-Luk re-seating after a round: the new seat of old seat `s` (the
// inverse of ops/solve_filter.reseat_order)
__device__ __forceinline__ int to_seat(int s, int dp) {
  const int h = dp / 2;
  return s == 0 ? 0 : s == h ? 1 : s < h - 1 ? s + 1 : s == h - 1 ? dp - 1 : s - 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the lower-triangle tile t (row ti >= column tj) of a grid of tiles
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((long long)i * (i + 1) / 2 > t) --i;
  while ((long long)(i + 1) * (i + 2) / 2 <= t) ++i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

__device__ __forceinline__ float4 ld4(const float* p, bool global) {
  return global ? __ldcg(reinterpret_cast<const float4*>(p))
                : *reinterpret_cast<const float4*>(p);
}

// Block-wide product acc(i, j) = sum_{k < kn} X(k)[i] Y(k)[j] over 4 x 4
// tiles, as solve_filter_smem.cu's tile_product: all rows4 x q4 tiles, or
// with `lower` those with ti >= tj; `skip(k)` (uniform over the block)
// leaves a k out; `xs(k)` scales row k of X; epi(i0, j0, acc) stores a
// tile and must not write what X or Y read.
template <class XRow, class YRow, class Skip, class XScale, class Epi>
__device__ __forceinline__ void tile_product(const Layout& L, XRow X, bool xg, YRow Y,
                                             bool yg, int kn, bool lower, int rows4,
                                             Skip skip, XScale xs, Epi epi) {
  const int n_tiles = lower ? L.tri : rows4 * L.q4;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int t0 = tid; t0 < n_tiles; t0 += NTP * THREADS) {
    int ti[NTP], tj[NTP];
    float acc[NTP][16];
#pragma unroll
    for (int u = 0; u < NTP; ++u) {
      const int t = t0 + u * THREADS;
      ti[u] = tj[u] = 0;
      if (t < n_tiles) {
        if (lower) {
          tri_tile(t, ti[u], tj[u]);
        } else {
          ti[u] = t / L.q4;
          tj[u] = t - ti[u] * L.q4;
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
      for (int u = 0; u < NTP; ++u) {
        if (t0 + u * THREADS < n_tiles) {
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
    for (int u = 0; u < NTP; ++u)
      if (t0 + u * THREADS < n_tiles) epi(4 * ti[u], 4 * tj[u], acc[u]);
  }
}

// X = (S + eps I)^-1 BD for S (symmetric, rows S(i) of dp floats), the
// right-hand sides in rows Y(i) (set here to BD, ending as X): the
// instances' right-looking Cholesky with the pivot rows staged (PIVOT_SMEM),
// `pv` 2 dp floats (shared memory, or the global slot from d = 4,563).
// Ends with a block barrier.
template <class SRow, class YRow>
__device__ __forceinline__ void chol_solve(const Layout& L, SRow S, YRow Y, const float* nov,
                                           float* rv, float* pv, float eps) {
  const int D = L.d, DP = L.dp;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (long long e = tid; e < (long long)DP * DP; e += THREADS) {
    const int i = (int)(e / DP), c = (int)(e - (long long)i * DP);
    Y(i)[c] = (i < D && c < D) ? bd_at(nov, i, c) : 0.f;
  }
#pragma unroll 1
  for (int j = 0; j < D; ++j) {
    __syncthreads();
    const float* sj = S(j);
    const float rj = 1.f / sqrtf(fmaxf(sj[j] + eps, 1e-30f));
    if (tid == 0) rv[j] = rj;
    if (j > 0 && warp == WARPS - 1) {
      const float rp = rv[j - 1];
      float* yp = Y(j - 1);
      for (int c = lane; c < D; c += 32) yp[c] *= rp;
    }
    // row j of S (= column j) and of Y, scaled by r_j
    const float* yj = Y(j);
    for (int c = tid; c < D; c += THREADS) {
      pv[c] = sj[c] * rj;
      pv[DP + c] = yj[c] * rj;
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < D; i += WARPS) {
      const float lij = pv[i];
      float* si = S(i);
      float* yi = Y(i);
      for (int c = lane; c < D; c += 32) {
        if (c >= i) si[c] = fmaf(-lij, pv[c], si[c]);
        yi[c] = fmaf(-lij, pv[DP + c], yi[c]);
      }
    }
  }
  __syncthreads();
  if (warp == WARPS - 1) {
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
    if (i < D - 1 && warp == WARPS - 1) {
      const float rn = rv[i + 1];
      float* yn = Y(i + 1);
      for (int c = lane; c < D; c += 32) yn[c] *= rn;
    }
    const float* yi = Y(i);
    for (int c = tid; c < D; c += THREADS) pv[c] = yi[c] * ri;
    __syncthreads();
    for (int l = warp; l < i; l += WARPS) {
      const float lil = S(l)[i] * rv[l];
      float* yl = Y(l);
      for (int c = lane; c < D; c += 32) yl[c] = fmaf(-lil, pv[c], yl[c]);
    }
  }
  __syncthreads();
  if (warp == WARPS - 1) {
    const float r0 = rv[0];
    float* y0 = Y(0);
    for (int c = lane; c < D; c += 32) y0[c] *= r0;
  }
  __syncthreads();
}

// kMoments = false: solve_filter (cand, mask, noise, n_in, m_in, rows,
// n_off -> field); b2_out is not read. kMoments = true: the lane
// solve_matrices from the moments, read through the same arguments: cand is
// m2 (P, d, d), mask msum (P, d), noise the noise sums (P, 6 npx), both not
// yet divided by n; m_in, rows and n_off are not read; field is a2t
// (P, d, d) and b2_out b2 (P, d). b2_out comes last so that the other
// arguments keep their places, and the solve_filter instance its code.
template <bool kMoments>
__global__ void __launch_bounds__(THREADS, 1)
solve_filter_big_kernel(const float* __restrict__ cand, const float* __restrict__ mask,
                        const float* __restrict__ noise, const float* __restrict__ n_in,
                        const float* __restrict__ m_in, const int* __restrict__ rows, float eps,
                        int n_rows, int n_off, int sweeps, float* scratch,
                        float* __restrict__ field, const Layout L,
                        float* __restrict__ b2_out) {
  const int D = L.d, DP = L.dp, HALF = L.half, Q4 = L.q4, T = THREADS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cemp = scratch + (size_t)blockIdx.x * (size_t)L.scratch;  // global, row stride DP
  float* hmat = cemp + (size_t)DP * DP;
  float* grow = hmat + (size_t)DP * DP;
  float* svec = sm + (size_t)L.rs * DP;
  float* gvec = grow + (size_t)L.grows * DP;
  float* vp[N_VEC];
#pragma unroll
  for (int k = 0; k < N_VEC; ++k) vp[k] = (k < L.vec_shared ? svec : gvec) + L.off[k];
  float* mv = vp[V_M];
  float* nov = vp[V_NOV];
  float* diag = vp[V_DIAG];
  float* fsc = vp[V_F];
  float* neg = vp[V_NEG];  // then b2
  float* rv = vp[V_R];     // the Cholesky's 1 / L[j][j]
  int* slot = reinterpret_cast<int*>(vp[V_SLOT]);
  float4* rec = reinterpret_cast<float4*>(vp[V_REC]);
  float* pv = vp[V_PIV];
  const Rows row{sm, grow, L.rs, DP};
  auto W = [&](int i) { return row(i); };       // W; candidates; S; Ct
  auto Q = [&](int i) { return row(DP + i); };  // Q; weighted candidates; Y
  auto cemp_row = [&](int k) { return cemp + (size_t)k * DP; };
  auto hmat_row = [&](int k) { return hmat + (size_t)k * DP; };
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long MAT = (long long)DP * DP;
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
    if constexpr (kMoments) {
      // m = msum / max(n, 1) and the mean noise, as a product with the
      // reciprocal (the d = 27 and 75 lane kernel's and the TPU kernel's)
      const float inv_n = 1.f / fmaxf(n, 1.f);
      for (int i = tid; i < DP; i += T) mv[i] = i < D ? mask[p * D + i] * inv_n : 0.f;
      for (int i = tid; i < L.nov; i += T) nov[i] = noise[p * L.nov + i] * inv_n;
    } else {
      for (int i = tid; i < DP; i += T) mv[i] = i < D ? m_in[p * D + i] : 0.f;
      for (int i = tid; i < L.nov; i += T) nov[i] = noise[p * L.nov + i];
    }

    // M2 = sum_o (w_o c_o) c_o^T over chunks of DP candidates (W rows: c_o,
    // Q rows: w_o c_o), NTP_M2 lower tiles a thread a pass; Cemp to the
    // scratch, mirrored from the lower tiles; or, from the moments, Cemp
    // from M2 row by row as given; then W = Cemp - BD, Q = I
    {
      const float nm1 = fmaxf(n - 1.f, 1.f);
      if constexpr (kMoments) {
        __syncthreads();  // m is whole
        const float* mp = cand + p * D * D;
        for (long long e = tid; e < MAT; e += T) {
          const int i = (int)(e / DP), j = (int)(e - (long long)i * DP);
          cemp[e] = (i < D && j < D) ? (mp[(size_t)i * D + j] - n * mv[i] * mv[j]) / nm1 : 0.f;
        }
      } else {
        constexpr int NT = NTP_M2;
#pragma unroll 1
        for (int pass = 0; pass < L.m2_passes; ++pass) {  // uniform: it holds barriers
          const int t0 = tid + pass * NT * T;
          int ti[NT], tj[NT];
          float acc[NT][16];
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            ti[u] = tj[u] = 0;
            if (t0 + u * T < L.tri) tri_tile(t0 + u * T, ti[u], tj[u]);
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[u][e] = 0.f;
          }
#pragma unroll 1
          for (int o0 = 0; o0 < n_off; o0 += DP) {
            const int cnt = min(DP, n_off - o0);
            __syncthreads();
            for (long long e = tid; e < (long long)cnt * DP; e += T) {
              const int o = (int)(e / DP), i = (int)(e - (long long)o * DP);
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
                if (t0 + u * T < L.tri) {
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
            if (t0 + u * T >= L.tri) continue;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                const int i = 4 * ti[u] + r, j = 4 * tj[u] + s;
                if (j > i) continue;  // the upper half of a diagonal tile
                const float ce =
                    (i < D && j < D) ? (acc[u][4 * r + s] - n * mv[i] * mv[j]) / nm1 : 0.f;
                cemp[(size_t)i * DP + j] = ce;
                cemp[(size_t)j * DP + i] = ce;
              }
          }
        }
      }
      __syncthreads();  // Cemp is whole
      for (long long e = tid; e < MAT; e += T) {
        const int i = (int)(e / DP), j = (int)(e - (long long)i * DP);
        W(i)[j] = (i < D && j < D) ? __ldcg(cemp + e) - bd_at(nov, i, j) : 0.f;
      }
      for (long long e = tid; e < MAT; e += T) {
        const int i = (int)(e / DP), c = (int)(e - (long long)i * DP);
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
    // W's rows (and Q's) hold DP Q4 16-byte units; a round's rotation takes
    // as many steps, HALF Q4 pair units of W, then of Q
    const unsigned units = 2u * (unsigned)HALF * (unsigned)Q4;
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
        // where g is the lane's group; each lane sums columns 4 (sub + 8 m).
        // CHUNK passes at a time; after each chunk lane `sub` of a group
        // forms the angles and row scales of its pass-(c0 + sub) pair, its
        // record {alpha, beta, rows} and the next seat map: a round's pairs
        // are disjoint, so a lane's pairs write disjoint diag, fsc, rec and
        // nxt entries, which no pivot product reads
        const int g = lane / 8, sub = lane % 8;
        const int p0 = 4 * warp + g;
#pragma unroll 1
        for (int c0 = 0; c0 < L.passes; c0 += CHUNK) {
          float sp[CHUNK];
          const float4* wv[CHUNK];
          const float4* qv[CHUNK];
          bool ok[CHUNK];
#pragma unroll
          for (int k = 0; k < CHUNK; ++k) {
            const int pk = p0 + (c0 + k) * PPASS;
            ok[k] = c0 + k < L.passes && pk < HALF;
            const int pc = ok[k] ? pk : 0;
            wv[k] = reinterpret_cast<const float4*>(W(cur[pc]));
            qv[k] = reinterpret_cast<const float4*>(Q(cur[pc + HALF]));
            sp[k] = 0.f;
          }
#pragma unroll 1
          for (int c4 = sub; c4 < Q4; c4 += 8) {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) {
              if (ok[k]) {
                const float4 a = wv[k][c4], b = qv[k][c4];
                sp[k] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, sp[k]))));
              }
            }
          }
#pragma unroll
          for (int o = 4; o >= 1; o /= 2)
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) sp[k] += __shfl_xor_sync(FULL, sp[k], o);
          float sum = sp[0];
#pragma unroll
          for (int k = 1; k < CHUNK; ++k)
            if (sub == k) sum = sp[k];
          const int i = p0 + (c0 + sub) * PPASS;
          if (c0 + sub < L.passes && i < HALF) {
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
            nxt[to_seat(i, DP)] = ra;
            nxt[to_seat(i + HALF, DP)] = rb;
          }
        }
        __syncthreads();
        // fast-Givens rows: top' = top + alpha bot, bot' = beta top + bot,
        // 16-byte unit u of the pair record's rows of W (u < HALF Q4) or Q
#pragma unroll 1
        for (unsigned u = tid; u < units; u += T) {
          const bool qm = u >= units / 2;
          const unsigned v = qm ? u - units / 2 : u;
          const unsigned pi = v / (unsigned)Q4, c4 = v - pi * (unsigned)Q4;
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
      // renormalize: fold the row scales into the rows of W, then of Q
      __syncthreads();
      for (int part = 0; part < 2; ++part)
        for (unsigned u = tid; u < units; u += T) {
          const int r = (int)(u / (unsigned)Q4);
          float4* x = reinterpret_cast<float4*>(row(part * DP + r)) + (u - (unsigned)r * Q4);
          const float f = fsc[r];
          const float4 y = *x;
          *x = make_float4(y.x * f, y.y * f, y.z * f, y.w * f);
        }
      __syncthreads();
      for (int i = tid; i < DP; i += T) fsc[i] = 1.f;
    }
    // exact eigenvalues lam_a = <W[a], Q[a]> by row; the negative ones
    __syncthreads();
    for (int a = warp; a < DP; a += WARPS) {
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
    tile_product(
        L, Q, false, Q, false, DP, true, Q4, [&](int k) { return neg[k] == 0.f; },
        [&](int k) { return neg[k]; },
        [&](int i0, int j0, const float* acc) {
          for (int r = 0; r < 4; ++r)
            for (int s = 0; s < 4; ++s) {
              const int i = i0 + r, j = j0 + s;
              if (j > i) continue;
              const float v =
                  (i < D && j < D) ? __ldcg(cemp + (size_t)i * DP + j) + acc[4 * r + s] : 0.f;
              W(i)[j] = v;
              W(j)[i] = v;
            }
        });
    __syncthreads();  // every thread has read Q before the solve writes it
    chol_solve(L, W, Q, nov, rv, pv, eps);  // Q rows: X1
    // A1^T = I - X1 in place; H = Cemp A1^T to the scratch (Cemp is
    // symmetric: H[i][c] = sum_k Cemp[k][i] A1^T[k][c])
    for (long long e = tid; e < MAT; e += T) {
      const int i = (int)(e / DP), c = (int)(e - (long long)i * DP);
      float* qi = Q(i);
      qi[c] = (i < D && c < D) ? (i == c ? 1.f : 0.f) - qi[c] : 0.f;
    }
    __syncthreads();
    tile_product(L, cemp_row, true, Q, false, D, false, Q4, none, one,
                 [&](int i0, int j0, const float* acc) {
                   for (int r = 0; r < 4; ++r) {
                     float* h = hmat + (size_t)(i0 + r) * DP + j0;
                     *reinterpret_cast<float4*>(h) =
                         make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2], acc[4 * r + 3]);
                   }
                 });
    __syncthreads();
    // S2 = A1 H + BD (cov2[i][j] = sum_k A1^T[k][i] H[k][j]; lower tiles,
    // mirrored) to W
    tile_product(L, Q, false, hmat_row, true, D, true, Q4, none, one,
                 [&](int i0, int j0, const float* acc) {
                   for (int r = 0; r < 4; ++r)
                     for (int s = 0; s < 4; ++s) {
                       const int i = i0 + r, j = j0 + s;
                       if (j > i) continue;
                       const float v =
                           (i < D && j < D) ? acc[4 * r + s] + bd_at(nov, i, j) : 0.f;
                       W(i)[j] = v;
                       W(j)[i] = v;
                     }
                 });
    __syncthreads();  // every thread has read A1^T before the solve writes Q
    chol_solve(L, W, Q, nov, rv, pv, eps);  // Q rows: X2
    if constexpr (kMoments) {
      // a2t[k][j] = delta_kj - X2[k][j] (= A2[j][k]) and b2[c] =
      // sum_k X2[k][c] m[k], pixel-major
      float* ap = field + p * D * D;
      for (long long e = tid; e < (long long)D * D; e += T) {
        const int k = (int)(e / D), j = (int)(e - (long long)k * D);
        ap[e] = (k == j ? 1.f : 0.f) - Q(k)[j];
      }
      for (int c = tid; c < D; c += T) {
        float s = 0.f;
        for (int k = 0; k < D; ++k) s = fmaf(Q(k)[c], mv[k], s);
        b2_out[p * D + c] = s;
      }
      continue;
    }
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
      for (long long e = tid; e < MAT; e += T) {
        const int o = (int)(e / DP), k = (int)(e - (long long)o * DP);
        W(k)[o] = (o < cnt && k < D) ? cp[(size_t)(o0 + o) * D + k] : 0.f;
      }
      __syncthreads();
      tile_product(L, W, false, Q, false, D, false, (cnt + 3) / 4, none, one,
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

// The layout at patch dimension d: out[0] shared bytes a block, out[1]
// rows of W and Q in shared memory, out[2] rows in the global slot,
// out[3] vectors in shared memory (of 9: m, noise, diag, f, neg, 1 / L,
// seat maps, pair records, staged pivot rows), out[4] floats of vectors
// in the global slot, out[5] the slot's floats a block. Returns 0, or -1
// for a d it cannot lay out (nothing written).
extern "C" int bcd_solve_filter_big_layout(int d, long long* out) {
  Layout L;
  if (!make_layout(d, &L)) return -1;
  out[0] = 4LL * L.smem_floats;
  out[1] = L.rs;
  out[2] = L.grows;
  out[3] = L.vec_shared;
  out[4] = L.gvec;
  out[5] = L.scratch;
  return 0;
}

// floats of global scratch the kernel needs for `n_blocks` blocks at patch
// dimension d, a 64-bit count (132 blocks pass 2^31 floats at d = 2187);
// -1 for a d it cannot lay out
extern "C" long long bcd_solve_filter_big_scratch_floats(int d, int n_blocks) {
  Layout L;
  if (n_blocks < 0 || !make_layout(d, &L)) return -1;
  return (long long)n_blocks * L.scratch;
}

extern "C" int bcd_solve_filter_big(const float* cand, const float* mask, const float* noise,
                                    const float* n, const float* m, const int* rows, float eps,
                                    int n_rows, int n_off, int d, int sweeps, float* scratch,
                                    int n_blocks, float* field, void* stream) {
  Layout L;
  if (!make_layout(d, &L) || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int bytes = 4 * L.smem_floats;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_filter_big_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  solve_filter_big_kernel<false><<<n_blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      cand, mask, noise, n, m, rows, eps, n_rows, n_off, sweeps, scratch, field, L, nullptr);
  return (int)cudaGetLastError();
}

// The lane solve_matrices at any patch dimension d (d = 27 and 75 run
// csrc/solve_filter.cu), pixel-major: m2 (P, d, d) raw masked second
// moments, msum (P, d) masked patch sums, nov (P, 6 npx) masked noise sums,
// n (P) -> a2t (P, d, d) with a2t[p][k][j] = A2[p][j][k], b2 (P, d). The
// same persistent grid, layout and per-block slot as bcd_solve_filter_big
// (bcd_solve_filter_big_scratch_floats(d, n_blocks) floats of scratch).
extern "C" int bcd_solve_matrices_big(const float* m2, const float* msum, const float* nov,
                                      const float* n, float eps, int n_pixels, int d, int sweeps,
                                      float* scratch, int n_blocks, float* a2t, float* b2,
                                      void* stream) {
  Layout L;
  if (!make_layout(d, &L) || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  if (n_pixels <= 0) return (int)cudaGetLastError();
  const int bytes = 4 * L.smem_floats;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_filter_big_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  solve_filter_big_kernel<true><<<n_blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      m2, msum, nov, n, nullptr, nullptr, eps, n_pixels, 0, sweeps, scratch, a2t, L, b2);
  return (int)cudaGetLastError();
}
