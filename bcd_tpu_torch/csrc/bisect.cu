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
// Layout: the TPU kernel runs all 128 pixels in one grid step; here a block
// takes PIX = 8 pixels (one 32-byte sector of each pixel-minor row of C),
// 32 threads a pixel, with A and V^T (28 x 28 each, pixel-minor) in shared
// memory, 16 blocks at P = 128. M2's 729 entries are summed in registers
// (23 a thread) over candidates staged 16 at a time.
//
// Bound: bytes (C, about 2.3 MB, read once); the operations take about
// 0.5 us at the fp32 rate (ops/bounds.bisect_stages). A simple kernel: each
// round is three barriers of latency-bound work on 16 SMs.
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

namespace {

constexpr int D = 27;                 // the patch dimension
constexpr int DP = 28;                // padded to even for the pairs
constexpr int HALF = DP / 2;
constexpr int ROUNDS = DP - 1;        // one sweep
constexpr int PIX = 8;                // pixels a block
constexpr int LANES = 32;             // threads a pixel
constexpr int THREADS = PIX * LANES;
constexpr int OC = 16;                // candidates staged at a time
constexpr int MAT = DP * DP * PIX;    // floats of one matrix for a block
constexpr int PER = (D * D + LANES - 1) / LANES;  // 27 x 27 entries a thread
constexpr int BYTES = 4 * (2 * MAT + 2 * HALF * PIX + DP * PIX) + 4 * 2 * DP;

static_assert(OC * (D + 1) * PIX <= MAT, "a chunk of C and its mask fits V^T");

// the 3x3 block's entry (a, b) is the noise channel CH[a][b]
__constant__ int CH[3][3] = {{0, 5, 4}, {5, 1, 3}, {4, 3, 2}};

// logical position i takes, for the next round, what sat at PERM(i)
__device__ __forceinline__ int perm(int i) {
  return i == 0 ? 0 : i == 1 ? HALF : i < HALF ? i - 1 : i < DP - 1 ? i + 1 : HALF - 1;
}

__global__ void __launch_bounds__(THREADS)
    bisect_kernel(const float* __restrict__ C, const float* __restrict__ mask,
                  const float* __restrict__ noise, const float* __restrict__ nvec,
                  const float* __restrict__ mvec, int O, int P, int last,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* A = smem;                  // [DP][DP][PIX]
  float* V = A + MAT;               // V^T, [DP][DP][PIX]; C's chunks during M2
  float* cs = V + MAT;              // [HALF][PIX]
  float* sn = cs + HALF * PIX;      // [HALF][PIX]
  float* vec = sn + HALF * PIX;     // m, lambda or a Cholesky column, [DP][PIX]
  int* ord = reinterpret_cast<int*>(vec + DP * PIX);  // two tables of DP

  const int tid = threadIdx.x;
  const int px = tid % PIX;
  const int lane = tid / PIX;
  const int p0 = blockIdx.x * PIX;
  const int p = p0 + px;
  const bool live = p < P;
#define AT(M, i, j) M[((i) * DP + (j)) * PIX + px]

  // --- m2 ------------------------------------------------------------------
  float acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;
  float* cw = V + OC * D * PIX;     // the chunk's mask, [OC][PIX]
  for (int o0 = 0; o0 < O; o0 += OC) {
    const int oc = min(OC, O - o0);
    __syncthreads();
    for (int e = tid; e < oc * D * PIX; e += THREADS) {
      const int pp = p0 + e % PIX;
      V[e] = pp < P ? C[(size_t)(o0 * D + e / PIX) * P + pp] : 0.f;
    }
    for (int e = tid; e < oc * PIX; e += THREADS) {
      const int pp = p0 + e % PIX;
      cw[e] = pp < P ? mask[(size_t)(o0 + e / PIX) * P + pp] : 0.f;
    }
    __syncthreads();
    for (int ol = 0; ol < oc; ++ol) {
      const float* c = V + ol * D * PIX;
      const float w = cw[ol * PIX + px];
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int e = lane + LANES * r;
        if (e < D * D)
          acc[r] = __fadd_rn(acc[r], __fmul_rn(__fmul_rn(c[(e / D) * PIX + px], w),
                                               c[(e % D) * PIX + px]));
      }
    }
  }
  if (last == 0) {
    if (live && lane < D) out[(size_t)lane * P + p] = acc[0];
    return;
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

// C (O, 27, P), mask (O, P), noise (54, P), n (1, P), m (27, P) and out
// (27, P), float32, contiguous; last 0 to 4 (m2, bd, jacobi, recon, chol)
extern "C" int bcd_bisect(const float* C, const float* mask, const float* noise, const float* n,
                          const float* m, int O, int P, int last, float* out, void* stream) {
  if (O < 0 || P <= 0 || last < 0 || last > 4) return (int)cudaErrorInvalidValue;
  // once, before any capture into a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      bisect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (attr != cudaSuccess) return (int)attr;
  bisect_kernel<<<(P + PIX - 1) / PIX, THREADS, BYTES, (cudaStream_t)stream>>>(
      C, mask, noise, n, m, O, P, last, out);
  return (int)cudaGetLastError();
}
