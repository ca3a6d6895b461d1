// scripts/bisect_kernel.py's staged d = 27 solve on Hopper (replaces its
// Pallas kernel, scripts/bisect_kernel.py:28-138, called at :142). For each
// pixel p of C (O, 27, P), mask (O, P), noise (54, P), n (1, P) and m (27,
// P), all pixel-minor, the kernel runs the script's schedule up to the stage
// `last` and writes row 0 of that stage's matrix to out (27, P):
//
//   0 m2:     M2 = sum over o, in order, of (c_o w_o) c_o^T;
//   1 bd:     S = Cemp - BD, Cemp = (M2 - (n m) m^T) / max(n - 1, 1) and BD
//             the 3x3 noise block of each of the 9 pixels (channels in the
//             order of the pairs (0,0),(1,1),(2,2),(1,2),(0,2),(0,1));
//   2 jacobi: one sweep of a two-sided Jacobi on S padded to 28: 27 rounds,
//             each rotating the 14 pairs (k, k + 14) at angles from tau =
//             (a_qq - a_pp) / 2 a_pq (t = 1 where tau = 0, t = 0 where
//             |a_pq| < 1e-30), rows of A and V^T, then the columns of A,
//             then the round-robin order [0, 14, 1..12, 15..27, 13];
//   3 recon:  the clamp V^T max(lambda, 0) V over all 28 rows;
//   4 chol:   a right-looking Cholesky of clamp + BD + 1e-8 I, pivots
//             rsqrt(max(diag, 1e-30)), rows above the pivot masked to 0.
//
// Every product, sum, division and square root is rounded as the script's
// element-wise program rounds it (__fmul_rn and friends keep nvcc from
// fusing them into FMAs), so the kernel repeats the plain version
// (ops/bisect.bisect_plain) where the card's PyTorch rounds the same way;
// rsqrtf stands for lax.rsqrt. The round-robin order is kept as an index
// table (the logical row i of A and V^T is the physical row ord[i]), not by
// moving data: after 27 rounds it is the identity again.
//
// Layout: the TPU kernel runs all 128 pixels in one grid step; here the
// entry launches two kernels on its stream, with M2 between them in a
// scratch (729, P) in device memory (373 KB at P = 128, resident in L2):
//
// - bisect_m2_kernel sums M2 over the card: a block takes PIX = 8 pixels
//   (one 32-byte sector of each pixel-minor row of C) and an eighth of M2,
//   128 blocks at P = 128. M2's rows and columns are cut into four groups
//   (0-6, 7-13, 14-20, 21-26); block k of a pixel group sums two 7 x 7
//   blocks of M2, (ga, gb) and (gb, ga), or (ga, ga) and (gb, gb) for k = 6
//   and 7 (PAIRS), so it stages only the 14 rows of C of groups ga and gb.
//   128 of its 256 threads sum, a thread one pixel, two rows i and four
//   columns j (8 sums, each staged c_i w feeding four and each c_j two).
//   C's 14 rows and the mask are staged OC = 16 candidates at a time in a
//   ring of STAGES = 11 in shared memory, by 16-byte cp.async (4-byte ones
//   where P is not a multiple of 4 or a base is not on 16 bytes;
//   zero-filled past O and P) at addresses each thread forms once:
//   the script's 169 candidates are all in flight at once, and past 176
//   the stage STAGES - 1 ahead is issued before a stage's sums. All 729
//   entries are formed and written at every stage; at m2 row 0 also goes
//   to out.
// - bisect_kernel (from bd on) runs the later stages, 8 pixels a block, 32
//   threads a pixel, with A and V^T (28 x 28 each, pixel-minor) in shared
//   memory, 16 blocks at P = 128.
//
// A thread-block cluster (8 blocks a pixel group, M2 through distributed
// shared memory into the first block, which ran the later stages) was
// tried first: the card holds 15 such clusters at once, so at P = 128 the
// 16th doubled up 8 SMs, and two of the blocks that ran the later stages
// shared an SM (PERF.md).
//
// Bound: bytes (C, about 2.3 MB, read once); the operations take about
// 0.5 us at the fp32 rate (ops/bounds.bisect_stages). Each Jacobi round is
// three barriers of latency-bound work on 16 SMs.
//
// BCD_BISECT_CUT, for `python -m bcd_tpu_torch.ops.bisect --split` only
// (wrong numbers on purpose): 1 leaves out M2's products (the staging
// alone), 2 the staging (the products of whatever shared memory holds).
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#ifndef BCD_BISECT_CUT
#define BCD_BISECT_CUT 0
#endif

namespace {

constexpr int D = 27;                 // the patch dimension
constexpr int DP = 28;                // padded to even for the pairs
constexpr int HALF = DP / 2;
constexpr int ROUNDS = DP - 1;        // one sweep
constexpr int PIX = 8;                // pixels a block
constexpr int LANES = 32;             // threads a pixel in the later stages
constexpr int THREADS = PIX * LANES;
constexpr int PARTS = 8;              // blocks of M2 a pixel group
constexpr int MAT = DP * DP * PIX;    // floats of one matrix for a block
constexpr int PER = (D * D + LANES - 1) / LANES;  // 27 x 27 entries a thread
// M2: a group of rows, the rows a block stages, the threads that sum
constexpr int GROUP = 7;
constexpr int ROWS = 2 * GROUP;
constexpr int SUMMERS = PIX * 2 * 8;  // pixel, block of M2, 4 row pairs x 2 column halves
constexpr int OC = 16;                // candidates a stage
constexpr int STAGES = 11;            // the script's 169 candidates in flight at once
constexpr int SLOT_C = OC * ROWS * PIX;           // a stage's C, [OC][ROWS][PIX]
constexpr int SLOT = SLOT_C + OC * PIX;           // and its mask, [OC][PIX]
constexpr int M2_BYTES = 4 * STAGES * SLOT;
constexpr int BYTES = 4 * (2 * MAT + 2 * HALF * PIX + DP * PIX) + 4 * 2 * DP;

static_assert(SUMMERS <= THREADS, "the summing threads are a block's");

// block k of a pixel group sums M2's blocks of the groups PAIRS[k]: (a, b)
// and (b, a), or for the last two (a, a) and (b, b)
__constant__ int PAIRS[PARTS][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2},
                                    {1, 3}, {2, 3}, {0, 1}, {2, 3}};

// the 3x3 block's entry (a, b) is the noise channel CH[a][b]
__constant__ int CH[3][3] = {{0, 5, 4}, {5, 1, 3}, {4, 3, 2}};

// logical position i takes, for the next round, what sat at PERM(i)
__device__ __forceinline__ int perm(int i) {
  return i == 0 ? 0 : i == 1 ? HALF : i < HALF ? i - 1 : i < DP - 1 ? i + 1 : HALF - 1;
}

// the rows of M2 (and of C) in group g: 7, and 6 in the last
__device__ __forceinline__ int group_rows(int g) { return g < 3 ? GROUP : D - 3 * GROUP; }

// kV: floats a copy, 4 (16 bytes: P a multiple of 4, C and mask on 16
// bytes) or 1
template <int kV>
__global__ void __launch_bounds__(THREADS)
    bisect_m2_kernel(const float* __restrict__ C, const float* __restrict__ mask, int O, int P,
                     int last, float* __restrict__ m2, float* __restrict__ out) {
  constexpr int COPIES = (SLOT / kV + THREADS - 1) / THREADS;  // copies a thread a stage
  extern __shared__ float ring[];  // M2's stages of C and the mask, [STAGES][SLOT]
  const int tid = threadIdx.x;
  const int px = tid % PIX;
  const int part = blockIdx.y;
  const int p0 = blockIdx.x * PIX;
  const int p = p0 + px;
  const bool live = p < P;

  const int ga = PAIRS[part][0], gb = PAIRS[part][1];
  const bool diag = part >= 6;
  // this thread's copies: the kV floats from e = kV (tid + THREADS k) of a
  // stage, at a fixed offset from the stage's first candidate (or none: -1)
  long long src[COPIES];
  int olk[COPIES];
#pragma unroll
  for (int k = 0; k < COPIES; ++k) {
    const int e = kV * (tid + THREADS * k);
    const int pe = p0 + e % PIX;  // the first pixel; with kV = 4 all four are live or none
    src[k] = -1;
    olk[k] = 0;
    if (e < SLOT_C) {
      const int ol = e / (ROWS * PIX), lr = e / PIX % ROWS;
      const int g = lr < GROUP ? ga : gb, r = lr % GROUP;
      olk[k] = ol;
      if (r < group_rows(g) && pe < P) src[k] = ((long long)ol * D + GROUP * g + r) * P + pe;
    } else if (e < SLOT) {
      const int ol = (e - SLOT_C) / PIX;
      olk[k] = ol;
      if (pe < P) src[k] = (long long)ol * P + pe;
    }
  }
  const uint32_t ring_u32 = smem_u32(ring);
  auto fill = [&](int s) {
    const uint32_t slot = ring_u32 + 4 * (s % STAGES) * SLOT;
    const int o0 = s * OC;
#pragma unroll
    for (int k = 0; k < COPIES; ++k) {
      const int e = kV * (tid + THREADS * k);
      if (e < SLOT) {
        const bool ok = src[k] >= 0 && o0 + olk[k] < O;
        const float* from = e < SLOT_C ? C + (size_t)o0 * D * P : mask + (size_t)o0 * P;
        cp_async<4 * kV>(slot + 4 * e, ok ? from + src[k] : C, ok ? 4 * kV : 0);
      }
    }
  };
  const int n_stages = (O + OC - 1) / OC;
#if BCD_BISECT_CUT != 2
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) fill(s);
    cp_async_commit();
  }
#endif
  // a summing thread: pixel px, block bsel of M2, rows rp and rp + 4 of it,
  // columns 4 ch .. 4 ch + 3 (where the group has them)
  const int sq = tid / PIX;
  const int bsel = sq / 8 % 2, rp = sq % 4, ch = sq / 4 % 2;
  const int rb = GROUP * bsel, cb = diag ? GROUP * bsel : GROUP * (1 - bsel);
  const int li0 = rb + rp, li1 = rb + (rp < 3 ? rp + 4 : rp);
  int lj[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) lj[jj] = cb + min(4 * ch + jj, GROUP - 1);
  float acc2[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc2[h][jj] = 0.f;
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
#if BCD_BISECT_CUT != 2
    cp_async_wait<STAGES - 2>();
#endif
    __syncthreads();
#if BCD_BISECT_CUT != 2
    // the slot of stage s - 1, whose sums every thread has finished
    if (s + STAGES - 1 < n_stages) fill(s + STAGES - 1);
    cp_async_commit();
#endif
#if BCD_BISECT_CUT != 1
    if (tid < SUMMERS) {
      // past O the candidates are zeros: each adds +0, which leaves a sum
      // as it is (a sum of products is never -0)
      const float* st = ring + (s % STAGES) * SLOT;
#pragma unroll
      for (int ol = 0; ol < OC; ++ol) {
        const float* c = st + ol * ROWS * PIX;
        const float w = st[SLOT_C + ol * PIX + px];
        const float cw0 = __fmul_rn(c[li0 * PIX + px], w);
        const float cw1 = __fmul_rn(c[li1 * PIX + px], w);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float cj = c[lj[jj] * PIX + px];
          acc2[0][jj] = __fadd_rn(acc2[0][jj], __fmul_rn(cw0, cj));
          acc2[1][jj] = __fadd_rn(acc2[1][jj], __fmul_rn(cw1, cj));
        }
      }
    }
#endif
  }
#if BCD_BISECT_CUT != 2
  cp_async_wait<0>();
#endif
  if (tid >= SUMMERS || !live) return;
  const int gi = bsel == 0 ? ga : gb, gj = diag ? gi : (bsel == 0 ? gb : ga);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (h ? li1 : li0) - rb;
    if ((h && rp == 3) || r >= group_rows(gi)) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int cc = 4 * ch + jj;
      if (cc >= group_rows(gj)) continue;
      const int i = GROUP * gi + r, j = GROUP * gj + cc;
      m2[(size_t)(i * D + j) * P + p] = acc2[h][jj];
      if (last == 0 && i == 0) out[(size_t)j * P + p] = acc2[h][jj];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    bisect_kernel(const float* __restrict__ m2, const float* __restrict__ noise,
                  const float* __restrict__ nvec, const float* __restrict__ mvec, int P, int last,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* A = smem;                  // [DP][DP][PIX]
  float* V = A + MAT;               // V^T, [DP][DP][PIX]
  float* cs = V + MAT;              // [HALF][PIX]
  float* sn = cs + HALF * PIX;      // [HALF][PIX]
  float* vec = sn + HALF * PIX;     // m, lambda or a Cholesky column, [DP][PIX]
  int* ord = reinterpret_cast<int*>(vec + DP * PIX);  // two tables of DP

  const int tid = threadIdx.x;
  const int px = tid % PIX;
  const int lane = tid / PIX;
  const int p = blockIdx.x * PIX + px;
  const bool live = p < P;
#define AT(M, i, j) M[((i) * DP + (j)) * PIX + px]

  float acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int e = lane + LANES * r;
    acc[r] = e < D * D && live ? m2[(size_t)e * P + p] : 0.f;
  }

  // --- bd: S = Cemp - BD -----------------------------------------------------
  if (lane < D) vec[lane * PIX + px] = live ? mvec[(size_t)lane * P + p] : 0.f;
  if (tid < DP) ord[tid] = tid;
  const float nv = live ? nvec[p] : 0.f;
  const float nm1 = fmaxf(__fsub_rn(nv, 1.f), 1.f);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int e = lane + LANES * r;
    if (e < D * D) {
      const int i = e / D, j = e % D;
      const float mm = __fmul_rn(__fmul_rn(nv, vec[i * PIX + px]), vec[j * PIX + px]);
      const float cemp = __fdiv_rn(__fsub_rn(acc[r], mm), nm1);
      float bd = 0.f;
      if (i / 3 == j / 3 && live) bd = noise[(size_t)(6 * (i / 3) + CH[i % 3][j % 3]) * P + p];
      acc[r] = __fsub_rn(cemp, bd);
    }
  }
  if (last == 1) {
    if (live && lane < D) out[(size_t)lane * P + p] = acc[0];
    return;
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int e = lane + LANES * r;
    if (e < D * D) AT(A, e / D, e % D) = acc[r];
  }
  for (int k = lane; k < DP; k += LANES) {
    AT(A, D, k) = 0.f;
    AT(A, k, D) = 0.f;
  }
  for (int e = lane; e < DP * DP; e += LANES) AT(V, e / DP, e % DP) = e / DP == e % DP ? 1.f : 0.f;
  __syncthreads();

  // --- jacobi: 27 rounds -------------------------------------------------------
  for (int round = 0; round < ROUNDS; ++round) {
    const int* cur = ord + (round & 1) * DP;
    int* nxt = ord + ((round + 1) & 1) * DP;
    if (lane < HALF) {
      const int a = cur[lane], b = cur[lane + HALF];
      const float app = AT(A, a, a), aqq = AT(A, b, b), apq = AT(A, a, b);
      const bool small = fabsf(apq) < 1e-30f;
      const float denom = small ? 1.f : __fmul_rn(2.f, apq);
      const float tau = __fdiv_rn(__fsub_rn(aqq, app), denom);
      const float sgn = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : 0.f);
      float t = __fdiv_rn(sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)))));
      if (tau == 0.f) t = 1.f;
      if (small) t = 0.f;
      const float c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(t, t))));
      cs[lane * PIX + px] = c;
      sn[lane * PIX + px] = __fmul_rn(t, c);
    }
    __syncthreads();
    // rows k and k + 14 of A and of V^T, over every column
    for (int u = lane; u < HALF * DP; u += LANES) {
      const int k = u / DP, col = u % DP;
      const int a = cur[k], b = cur[k + HALF];
      const float c = cs[k * PIX + px], s = sn[k * PIX + px];
      const float top = AT(A, a, col), bot = AT(A, b, col);
      AT(A, a, col) = __fsub_rn(__fmul_rn(c, top), __fmul_rn(s, bot));
      AT(A, b, col) = __fadd_rn(__fmul_rn(s, top), __fmul_rn(c, bot));
      const float vtop = AT(V, a, col), vbot = AT(V, b, col);
      AT(V, a, col) = __fsub_rn(__fmul_rn(c, vtop), __fmul_rn(s, vbot));
      AT(V, b, col) = __fadd_rn(__fmul_rn(s, vtop), __fmul_rn(c, vbot));
    }
    __syncthreads();
    // columns k and k + 14 of A, over every row; the next round's order
    for (int u = lane; u < HALF * DP; u += LANES) {
      const int k = u % HALF, row = u / HALF;
      const int a = cur[k], b = cur[k + HALF];
      const float c = cs[k * PIX + px], s = sn[k * PIX + px];
      const float lef = AT(A, row, a), rig = AT(A, row, b);
      AT(A, row, a) = __fsub_rn(__fmul_rn(c, lef), __fmul_rn(s, rig));
      AT(A, row, b) = __fadd_rn(__fmul_rn(s, lef), __fmul_rn(c, rig));
    }
    if (tid < DP) nxt[tid] = cur[perm(tid)];
    __syncthreads();
  }
  const int* fin = ord + (ROUNDS & 1) * DP;
  if (last == 2) {
    if (live && lane < D) out[(size_t)lane * P + p] = AT(A, fin[0], fin[lane]);
    return;
  }

  // --- recon: V^T max(lambda, 0) V over all 28 rows -----------------------------
  if (lane < DP) {
    const float l = AT(A, fin[lane], fin[lane]);
    vec[lane * PIX + px] = l < 0.f ? 0.f : l;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int e = lane + LANES * r;
    if (e < D * D) {
      const int i = e / D, j = e % D;
      float s = 0.f;
      for (int k = 0; k < DP; ++k) {
        const int row = fin[k];
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(AT(V, row, i), vec[k * PIX + px]), AT(V, row, j)));
      }
      acc[r] = s;
    }
  }
  if (last == 3) {
    if (live && lane < D) out[(size_t)lane * P + p] = acc[0];
    return;
  }

  // --- chol: the factor of clamp + BD + 1e-8 I ---------------------------------
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int e = lane + LANES * r;
    if (e < D * D) {
      const int i = e / D, j = e % D;
      float bd = 0.f;
      if (i / 3 == j / 3 && live) bd = noise[(size_t)(6 * (i / 3) + CH[i % 3][j % 3]) * P + p];
      AT(A, i, j) = __fadd_rn(__fadd_rn(acc[r], bd), i == j ? 1e-8f : 0.f);
    }
  }
  __syncthreads();
  for (int j = 0; j < D; ++j) {
    if (lane < D) {
      const float inv = rsqrtf(fmaxf(AT(A, j, j), 1e-30f));
      const float col = __fmul_rn(__fmul_rn(AT(A, lane, j), inv), lane >= j ? 1.f : 0.f);
      vec[lane * PIX + px] = col;
      if (lane == 0 && live) out[(size_t)j * P + p] = col;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int e = lane + LANES * r;
      if (e < D * D) {
        const int i = e / D, k = e % D;
        AT(A, i, k) = __fsub_rn(AT(A, i, k), __fmul_rn(vec[i * PIX + px], vec[k * PIX + px]));
      }
    }
    __syncthreads();
  }
#undef AT
}

}  // namespace

// C (O, 27, P), mask (O, P), noise (54, P), n (1, P), m (27, P), the
// scratch m2 (729, P) and out (27, P), float32, contiguous; last 0 to 4 (m2,
// bd, jacobi, recon, chol)
extern "C" int bcd_bisect(const float* C, const float* mask, const float* noise, const float* n,
                          const float* m, int O, int P, int last, float* m2, float* out,
                          void* stream) {
  if (O < 0 || P <= 0 || last < 0 || last > 4) return (int)cudaErrorInvalidValue;
  // once, before any capture into a CUDA graph
  static const cudaError_t attr = [] {
    cudaError_t rc = cudaFuncSetAttribute(bisect_m2_kernel<4>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, M2_BYTES);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(bisect_m2_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                M2_BYTES);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(bisect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    return rc;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const cudaStream_t st = (cudaStream_t)stream;
  const int groups = (P + PIX - 1) / PIX;
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  if (vec)
    bisect_m2_kernel<4><<<dim3(groups, PARTS), THREADS, M2_BYTES, st>>>(C, mask, O, P, last, m2,
                                                                         out);
  else
    bisect_m2_kernel<1><<<dim3(groups, PARTS), THREADS, M2_BYTES, st>>>(C, mask, O, P, last, m2,
                                                                         out);
  if (last > 0) bisect_kernel<<<groups, THREADS, BYTES, st>>>(m2, noise, n, m, P, last, out);
  return (int)cudaGetLastError();
}
