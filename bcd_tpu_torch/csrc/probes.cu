// Hopper microbenchmarks of the three TPU-compiler probes in scripts/: each
// kernel computes what its script's Pallas kernel computes, at the script's
// shapes, so that the script's question can be asked of this card. Simple
// kernels, not tuned. Wrappers, plain versions and the timing entry point:
// bcd_tpu_torch/ops/probes.py.
//
// - transpose (replaces scripts/probe_transpose.py::run, kernels
//   _kernel_mxu, _kernel_swap, _kernel_noop, _kernel_fwd_only): K1's packed
//   moments m2 (P, K) pixel-major, expanded by the 0/1 matrix E (M, K), one 1
//   a row (ops/fused.tri_geometry(27): M = 729, K = 378), to lane-major
//   lanes (M, P) = E m2^T, and transposed back, back (P, M) = lanes^T.
//   A: tensor-core products, mma.sync TF32 with every fp32 input split into
//      three TF32 parts (the counterpart of the MXU's bf16x3 passes at
//      HIGHEST): lanes = E m2^T, then back = I lanes^T, the identity product
//      over each 32-pixel tile's own block (the script's I_128 a block).
//   B: an index gather (back = m2[:, index]) and a transpose through a
//      shared-memory tile (lanes).
//   C: the I/O baseline: m2 read, lanes and back written, no work (each
//      output is m2's elements in order, repeated).
//   D: A's forward product only (lanes).
//   Bound: bytes (each input read once, each output written once).
// - mosaic (replaces scripts/probe_mosaic.py::run, kernels _kernel_aligned,
//   _kernel_unaligned): out (npix, C) = sum over windows k of w_k g[row_k :
//   row_k + npix] of a (rows, C) slab; the windows' rows and weights are
//   runtime values (the script's shifts come from scalar memory). A thread
//   sums four consecutive floats of the flat output in registers, window by
//   window in order, each term rounded as a product and then a sum. A row of
//   C = 729 floats is 2,916 bytes, so a window's flat offset row_k C is a
//   multiple of four floats only where row_k is: those windows are read in
//   16-byte loads, the others in 4-byte loads.
//   Bound: bytes.
// - banded dot (replaces scripts/probe_banded_dot.py::run_case, kernels
//   _kernel_batched, _kernel_loop): O[y] = B[y] S[y] for 0/1 band matrices
//   B (Y, T, T), nonzero only within |i - k| <= 6, and S (Y, T, C).
//   batched: mma.sync TF32 over the whole T x T matrix; B is exact in TF32,
//      S is split into three TF32 parts.
//   loop: CUDA-core FMAs over the band only.
//   Bound: bytes.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // warps a block of the mma kernels

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + mid + lo exactly, each a TF32 value: hi takes x's leading 11
// bits, mid the next 11 or 12 of the remainder (exact in fp32), lo the rest
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  mid = to_tf32(r);
  lo = to_tf32(r - __uint_as_float(mid));
}

// c += a b for a 16 x 8 x 8 tile: a rows g, g + 8 and columns t, t + 4
// (a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4)), b
// rows t, t + 4 of column g, c rows g, g + 8 and columns 2t, 2t + 1, where
// g = lane / 4 and t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the six products of three-part inputs down to the third part: big += the
// leading parts' product, small += the others, smallest first
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&a)[3][4], const uint32_t (&b)[3][2]) {
  mma_tf32(small, a[2], b[0]);
  mma_tf32(small, a[1], b[1]);
  mma_tf32(small, a[0], b[2]);
  mma_tf32(small, a[1], b[0]);
  mma_tf32(small, a[0], b[1]);
  mma_tf32(big, a[0], b[0]);
}

// transpose A (kBack) and D: a warp computes a 16 x 32 tile of lanes (rows
// r0.., pixels p0..) over K in steps of 8; A then multiplies the tile, from
// shared memory, by the identity into the 32 x 16 tile of back
template <bool kBack>
__global__ void __launch_bounds__(32 * WARPS)
transpose_mma_kernel(const float* __restrict__ m2, const float* __restrict__ expand, int P,
                     int K, int M, float* __restrict__ lanes, float* __restrict__ back) {
  __shared__ float fs[WARPS][16][36];  // a row stride of 36: no bank conflict on b's reads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = P / 32;
  const int w = blockIdx.x * WARPS + warp;
  const int mt = w / n_tiles, nt = w - mt * n_tiles;
  if (mt * 16 >= M) return;
  const int r0 = mt * 16, p0 = nt * 32;
  auto e_at = [&](int r, int k) {
    return (r < M && k < K) ? expand[(size_t)r * K + k] : 0.f;
  };
  float big[4][4] = {}, small[4][4] = {};
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int ka = k0 + t, kb = k0 + t + 4;
    const float ev[4] = {e_at(r0 + g, ka), e_at(r0 + g + 8, ka), e_at(r0 + g, kb),
                         e_at(r0 + g + 8, kb)};
    uint32_t a[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split3(ev[i], a[0][i], a[1][i], a[2][i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* mp = m2 + (size_t)(p0 + 8 * j + g) * K;
      uint32_t b[3][2];
      split3(ka < K ? mp[ka] : 0.f, b[0][0], b[1][0], b[2][0]);
      split3(kb < K ? mp[kb] : 0.f, b[0][1], b[1][1], b[2][1]);
      mma3(big[j], small[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = g + 8 * h, pl = 8 * j + 2 * t;
      const float v0 = big[j][2 * h] + small[j][2 * h];
      const float v1 = big[j][2 * h + 1] + small[j][2 * h + 1];
      if (r0 + rl < M) {
        lanes[(size_t)(r0 + rl) * P + p0 + pl] = v0;
        lanes[(size_t)(r0 + rl) * P + p0 + pl + 1] = v1;
      }
      if (kBack) {
        fs[warp][rl][pl] = v0;
        fs[warp][rl][pl + 1] = v1;
      }
    }
  if (!kBack) return;
  __syncwarp();
  const uint32_t one = __float_as_uint(1.f);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {  // pixels p0 + 16 mi .. p0 + 16 mi + 15
    float bb[2][4] = {}, sb[2][4] = {};
#pragma unroll
    for (int kk = 16 * mi; kk < 16 * mi + 16; kk += 8) {
      const int pr = 16 * mi + g;
      uint32_t a[3][4] = {};
      a[0][0] = pr == kk + t ? one : 0u;
      a[0][1] = pr + 8 == kk + t ? one : 0u;
      a[0][2] = pr == kk + t + 4 ? one : 0u;
      a[0][3] = pr + 8 == kk + t + 4 ? one : 0u;
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // rows r0 + 8 j .. r0 + 8 j + 7 of lanes
        uint32_t b[3][2];
        split3(fs[warp][8 * j + g][kk + t], b[0][0], b[1][0], b[2][0]);
        split3(fs[warp][8 * j + g][kk + t + 4], b[0][1], b[1][1], b[2][1]);
        mma3(bb[j], sb[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 16 * mi + g + 8 * h, r = r0 + 8 * j + 2 * t;
        if (r < M) back[(size_t)p * M + r] = bb[j][2 * h] + sb[j][2 * h];
        if (r + 1 < M) back[(size_t)p * M + r + 1] = bb[j][2 * h + 1] + sb[j][2 * h + 1];
      }
  }
}

// transpose B: a 32 x 32 tile, 32 x 8 threads; back[p][r] = m2[p][index[r]]
// (coalesced over r), then lanes[r][p] from the tile (coalesced over p)
__global__ void __launch_bounds__(256)
transpose_gather_kernel(const float* __restrict__ m2, const int* __restrict__ index, int P,
                        int K, int M, float* __restrict__ lanes, float* __restrict__ back) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, p0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = r0 + tx;
  const int src = r < M ? index[r] : 0;
  for (int i = ty; i < 32; i += 8) {
    const int p = p0 + i;
    const float v = (r < M && p < P) ? m2[(size_t)p * K + src] : 0.f;
    tile[i][tx] = v;
    if (r < M && p < P) back[(size_t)p * M + r] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int rr = r0 + i, p = p0 + tx;
    if (rr < M && p < P) lanes[(size_t)rr * P + p] = tile[tx][i];
  }
}

// transpose C: lanes and back (n_out floats each) = m2's n_in floats in
// order, repeated, in 16-byte units
__global__ void __launch_bounds__(256)
transpose_copy_kernel(const float4* __restrict__ m2, long long n_in4, long long n_out4,
                      float4* __restrict__ lanes, float4* __restrict__ back) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_out4; i += stride) {
    const float4 v = m2[i % n_in4];
    lanes[i] = v;
    back[i] = v;
  }
}

constexpr int MAX_WINDOWS = 64;

// the windows of a mosaic sum, passed by value: flat offsets row_k C, weights
struct Windows {
  int n;
  long long off[MAX_WINDOWS];
  float w[MAX_WINDOWS];
};

__global__ void __launch_bounds__(256)
mosaic_kernel(const float* __restrict__ g, long long n4, const Windows win,
              float4* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int k = 0; k < win.n; ++k) {
    const float* src = g + win.off[k] + 4 * i;
    float4 v;
    if ((win.off[k] & 3) == 0) {
      v = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      v = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
    }
    const float w = win.w[k];
    acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
    acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
    acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
    acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  }
  out[i] = acc;
}

// banded dot, batched: a warp computes a 16 x 32 tile of O[y] over all of
// K = T; B's 0/1 values are exact TF32, S's are split into three parts
__global__ void __launch_bounds__(32 * WARPS)
banded_mma_kernel(const float* __restrict__ bm, const float* __restrict__ s, int Y, int T, int C,
                  float* __restrict__ o) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mts = T / 16, nts = C / 32;
  const int w = blockIdx.x * WARPS + warp;
  const int y = w / (mts * nts);
  if (y >= Y) return;
  const int rem = w - y * mts * nts;
  const int r0 = (rem / nts) * 16, c0 = (rem % nts) * 32;
  const float* by = bm + (size_t)y * T * T;
  const float* sy = s + (size_t)y * T * C;
  float big[4][4] = {}, small[4][4] = {};
#pragma unroll 1
  for (int k0 = 0; k0 < T; k0 += 8) {
    const uint32_t a[4] = {to_tf32(by[(r0 + g) * T + k0 + t]),
                           to_tf32(by[(r0 + g + 8) * T + k0 + t]),
                           to_tf32(by[(r0 + g) * T + k0 + t + 4]),
                           to_tf32(by[(r0 + g + 8) * T + k0 + t + 4])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j + g;
      uint32_t hi[2], mid[2], lo[2];
      split3(sy[(size_t)(k0 + t) * C + c], hi[0], mid[0], lo[0]);
      split3(sy[(size_t)(k0 + t + 4) * C + c], hi[1], mid[1], lo[1]);
      mma_tf32(small[j], a, lo);
      mma_tf32(small[j], a, mid);
      mma_tf32(big[j], a, hi);
    }
  }
  float* oy = o + (size_t)y * T * C;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, c = c0 + 8 * j + 2 * t;
      oy[(size_t)r * C + c] = big[j][2 * h] + small[j][2 * h];
      oy[(size_t)r * C + c + 1] = big[j][2 * h + 1] + small[j][2 * h + 1];
    }
}

// banded dot, loop: a thread an output O[y][i][c], the FMAs of the band
// k = i - band .. i + band in order
__global__ void __launch_bounds__(256)
banded_loop_kernel(const float* __restrict__ bm, const float* __restrict__ s, int T, int C,
                   int band, float* __restrict__ o) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y, y = blockIdx.z;
  if (c >= C) return;
  const float* brow = bm + ((size_t)y * T + i) * T;
  const float* sy = s + (size_t)y * T * C + c;
  float acc = 0.f;
  const int k1 = min(T - 1, i + band);
  for (int k = max(0, i - band); k <= k1; ++k) acc = fmaf(brow[k], sy[(size_t)k * C], acc);
  o[((size_t)y * T + i) * C + c] = acc;
}

}  // namespace

// transpose A (back != nullptr) or D (back == nullptr): P a multiple of 32
extern "C" int bcd_probe_transpose_mma(const float* m2, const float* expand, int P, int K, int M,
                                       float* lanes, float* back, void* stream) {
  if (P <= 0 || P % 32 != 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)((M + 15) / 16) * (P / 32);
  const int blocks = (int)((warps + WARPS - 1) / WARPS);
  if (back) {
    transpose_mma_kernel<true><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        m2, expand, P, K, M, lanes, back);
  } else {
    transpose_mma_kernel<false><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        m2, expand, P, K, M, lanes, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int bcd_probe_transpose_gather(const float* m2, const int* index, int P, int K, int M,
                                          float* lanes, float* back, void* stream) {
  if (P <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  transpose_gather_kernel<<<dim3((M + 31) / 32, (P + 31) / 32), dim3(32, 8), 0,
                            (cudaStream_t)stream>>>(m2, index, P, K, M, lanes, back);
  return (int)cudaGetLastError();
}

// n_in and n_out floats, multiples of 4
extern "C" int bcd_probe_transpose_copy(const float* m2, long long n_in, long long n_out,
                                        float* lanes, float* back, void* stream) {
  if (n_in <= 0 || n_in % 4 != 0 || n_out <= 0 || n_out % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n4 = n_out / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  transpose_copy_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(m2), n_in / 4, n4, reinterpret_cast<float4*>(lanes),
      reinterpret_cast<float4*>(back));
  return (int)cudaGetLastError();
}

// out (npix, cols) = sum_k w[k] g[rows[k] : rows[k] + npix] of g (n_rows,
// cols); rows and w are host arrays of n_win entries, each window within g;
// npix cols a multiple of 4
extern "C" int bcd_probe_mosaic(const float* g, int n_rows, int cols, int npix, const int* rows,
                                const float* w, int n_win, float* out, void* stream) {
  const long long n = (long long)npix * cols;
  if (n_win < 1 || n_win > MAX_WINDOWS || n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  Windows win;
  win.n = n_win;
  for (int k = 0; k < n_win; ++k) {
    if (rows[k] < 0 || rows[k] + npix > n_rows) return (int)cudaErrorInvalidValue;
    win.off[k] = (long long)rows[k] * cols;
    win.w[k] = w[k];
  }
  const long long n4 = n / 4;
  mosaic_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      g, n4, win, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// T a multiple of 16, C of 32
extern "C" int bcd_probe_banded_mma(const float* b, const float* s, int Y, int T, int C,
                                    float* out, void* stream) {
  if (Y <= 0 || T <= 0 || T % 16 != 0 || C <= 0 || C % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)Y * (T / 16) * (C / 32);
  banded_mma_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), 32 * WARPS, 0,
                      (cudaStream_t)stream>>>(b, s, Y, T, C, out);
  return (int)cudaGetLastError();
}

extern "C" int bcd_probe_banded_loop(const float* b, const float* s, int Y, int T, int C,
                                     int band, float* out, void* stream) {
  if (Y <= 0 || T <= 0 || C <= 0 || band < 0) return (int)cudaErrorInvalidValue;
  banded_loop_kernel<<<dim3((C + 255) / 256, T, Y), 256, 0, (cudaStream_t)stream>>>(
      b, s, T, C, band, out);
  return (int)cudaGetLastError();
}
