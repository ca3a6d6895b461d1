// Hopper microbenchmarks of the three TPU-compiler probes in scripts/: each
// kernel computes what its script's Pallas kernel computes, at the script's
// shapes, so that the script's question can be asked of this card. Simple
// kernels, not tuned, but for transpose A and D and the batched banded dot
// (below). Wrappers, plain
// versions and the timing entry point: bcd_tpu_torch/ops/probes.py.
//
// - transpose (replaces scripts/probe_transpose.py::run, kernels
//   _kernel_mxu, _kernel_swap, _kernel_noop, _kernel_fwd_only): K1's packed
//   moments m2 (P, K) pixel-major, expanded by the 0/1 matrix E (M, K), one 1
//   a row (ops/fused.tri_geometry(27): M = 729, K = 378), to lane-major
//   lanes (M, P) = E m2^T, and transposed back, back (P, M) = lanes^T.
//   A and D (replace _kernel_mxu and _kernel_fwd_only): one product on the
//      tensor cores, wgmma TF32 with m2 split into three TF32 parts (the
//      counterpart of the MXU's passes at HIGHEST), exact for a one-hot E
//      (transpose_wgmma_kernel). A writes lanes and back from the one
//      accumulator, D lanes alone. The script's A formed back as a second
//      product, with the identity, because Mosaic had no transpose
//      (probe_transpose.py:1-16); that is the same function, so A here
//      stores the accumulator twice instead.
//   B: an index gather (back = m2[:, index]) and a transpose through a
//      shared-memory tile (lanes).
//   C: the I/O baseline: m2 read, lanes and back written, no work (each
//      output is m2's elements in order, repeated).
//   D: A's forward product only (lanes).
//   Bound: bytes (each input read once, each output written once): A 0.0051
//   ms, D 0.0030 ms at P = 2304 (a gather needs only E's index). A product
//   cannot reach it: A's and D's floor is their three TF32 products, 3.8
//   GFLOP at 495 TFLOP/s, about 8 us.
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
//   batched: mma.sync TF32 over the whole T x T matrix from B and S staged
//      in shared memory by cp.async; B is exact in TF32, S is split into
//      three TF32 parts once (banded_mma_kernel).
//   loop: CUDA-core FMAs over the band only.
//   Bound: bytes.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

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

// transpose A and D's tile: TX_WG warpgroups, each 64 pixels (wgmma's M),
// by TX_NR rows of E (its N), over K in stages of TX_KS (four k-steps of 8)
// in a ring of TX_STAGES. 128 x 128 gives 18 x 6 = 108 blocks for P = 2304,
// one wave on 132 SMs, and reads m2 6 times and E 18 times, about 41 MB
// from L2 (64 x 248 read E 36 times, 50 MB)
constexpr int TX_WG = 2, TX_NR = 128, TX_KS = 32, TX_STAGES = 4;
constexpr int TX_PX = 64 * TX_WG, TX_THREADS = 128 * TX_WG;
// floats a staged m2 row: the A fragments' loads (8 rows, 4 columns) hit
// 32 banks
constexpr int TX_A_PITCH = TX_KS + 4;
// staged E, K-major without swizzle as wgmma's descriptor reads it: a 4-float
// K chunk of all TX_NR rows, 16 bytes a row (core matrices of 8 rows 128
// bytes apart, the SBO), then the next chunk TX_B_CHUNK floats on (the LBO;
// one row of padding, so that a warp's 8-byte copies of two rows write 32
// banks)
constexpr int TX_B_CHUNK = 4 * (TX_NR + 1);
constexpr int TX_A_FLOATS = TX_PX * TX_A_PITCH;
constexpr int TX_STAGE_FLOATS = TX_A_FLOATS + (TX_KS / 4) * TX_B_CHUNK;
// the accumulator staged row of E by pixel for the stores: an odd pitch, so
// that a column (back's row) reads 32 banks
constexpr int TX_OUT_PITCH = TX_PX + 1;
constexpr int TX_BYTES = 4 * (TX_STAGES * TX_STAGE_FLOATS > TX_NR * TX_OUT_PITCH
                                  ? TX_STAGES * TX_STAGE_FLOATS
                                  : TX_NR * TX_OUT_PITCH);
static_assert(TX_BYTES <= 232448, "the ring exceeds a block's shared memory");
static_assert((4 * TX_A_FLOATS) % 16 == 0 && (4 * TX_B_CHUNK) % 16 == 0 &&
                  (4 * TX_STAGE_FLOATS) % 16 == 0,
              "wgmma's operands start on 16 bytes");

// the descriptor of staged E (K-major, no swizzle): start address, leading
// byte offset (between K chunks), stride byte offset (between groups of 8
// rows), each in 16-byte units
__device__ __forceinline__ uint64_t tx_desc(uint32_t addr) {
  constexpr uint64_t LBO = 4 * TX_B_CHUNK / 16, SBO = 128 / 16;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (LBO << 16) | (SBO << 32);
}

// keep the compiler from moving accesses of the accumulator across the
// wgmma fence and wait
__device__ __forceinline__ void tx_pin(float (&d)[TX_NR / 2]) {
#pragma unroll
  for (int i = 0; i < TX_NR / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the wgmma's accumulator operands d[i] .. d[i + 7]
#define TX_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) += a (64 x 8, TF32 from registers: a[0] (g, t), a[1] (g + 8,
// t), a[2] (g, t + 4), a[3] (g + 8, t + 4) of warp w's rows 16 w..) times the
// 128 x 8 TF32 tile of E at desc, transposed; d[4 j + 2 h + c] is row
// 16 w + g + 8 h, column 8 j + 2 t + c
__device__ __forceinline__ void tx_wgmma(float (&d)[TX_NR / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  static_assert(TX_NR == 128, "the instruction below is m64n128k8");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TX_D8(0), TX_D8(8), TX_D8(16), TX_D8(24), TX_D8(32), TX_D8(40), TX_D8(48), TX_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// transpose A (kBack) and D on Hopper's tensor cores, bound by their three
// products (about 8 us at P = 2304, above the bytes bound). A block
// computes the pixel-major tile back[p0.., r0..] = m2 E^T, 128 pixels (a
// warpgroup each 64) by 128 rows of E, with wgmma (m64n128k8, TF32):
// - m2 is the A operand, from registers: a thread loads its fragment from
//   the staged rows and splits each float into three TF32 parts once
//   (split3), in registers; E, exact in TF32 (0/1), is the B operand, read
//   by descriptor from shared memory, both K-major as TF32 wgmma needs.
// - Three products a k-step, E lo, E mid, E hi, into one fp32 accumulator
//   in that order (six for mma.sync's two three-part inputs, half of them
//   of E's zero parts). For a one-hot E each sum is exact: every other
//   term is an exact zero, lo + mid is exactly m2 - hi, then + hi gives m2.
// - m2's and E's rows are staged once a block, in a ring of TX_STAGES
//   stages filled by cp.async while the products of an earlier stage run:
//   the stage three ahead is issued after a stage's products and before
//   their wait. A row is 4 K bytes, 1,512 at K = 378: not a multiple of 16,
//   so no 16-byte copy or TMA tensor map fits it, and the copies are 8
//   bytes (kUnit = 2; 4 where K is odd or a base is not 8-byte aligned).
//   Each thread copies the same columns of every 16th row (of every 8th
//   for 4-byte copies) at every stage, from addresses it forms once: a
//   warp copies 256 contiguous bytes of two rows, 16 copies a thread a
//   stage, a few instructions each, so that the copies' issue stays small
//   beside the products.
// - The epilogue stages the accumulator in shared memory and writes lanes
//   rows (contiguous in p) and, for A, back rows (contiguous in r; 2,916
//   bytes apart at M = 729, so 4-byte aligned only) in coalesced 4-byte
//   stores, both from the one accumulator: no second product.
// Ragged P and M: rows past them are zero-filled and not stored.
template <bool kBack, int kUnit>
__global__ void __launch_bounds__(TX_THREADS, 1)
transpose_wgmma_kernel(const float* __restrict__ m2, const float* __restrict__ e, int P,
                       int K, int M, float* __restrict__ lanes, float* __restrict__ back) {
  extern __shared__ __align__(128) float smem[];
  constexpr int PER_ROW = TX_KS / kUnit, STEP = TX_THREADS / PER_ROW;
  static_assert(TX_PX % STEP == 0 && TX_NR % STEP == 0, "a copy's rows split evenly");
  const int p0 = blockIdx.x * TX_PX, r0 = blockIdx.y * TX_NR;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_k = (K + TX_KS - 1) / TX_KS;
  // this thread's copies: columns kq .. kq + kUnit of rows row0 + STEP j
  const int row0 = threadIdx.x / PER_ROW, kq = threadIdx.x % PER_ROW * kUnit;
  const size_t step = (size_t)STEP * K;
  const float* a_src = m2 + (size_t)(p0 + row0) * K + kq;
  const float* b_src = e + (size_t)(r0 + row0) * K + kq;
  const uint32_t base = smem_u32(smem);
  const uint32_t a_dst = base + 4 * (row0 * TX_A_PITCH + kq);
  const uint32_t b_dst = base + 4 * (TX_A_FLOATS + kq / 4 * TX_B_CHUNK + 4 * row0 + kq % 4);
  auto fill = [&](int s) {
    const uint32_t slot = 4 * (s % TX_STAGES) * TX_STAGE_FLOATS;
    const int k0 = s * TX_KS;
    const bool k_ok = k0 + kq < K;
#pragma unroll
    for (int j = 0; j < TX_PX / STEP; ++j) {
      const bool ok = k_ok && p0 + row0 + STEP * j < P;
      cp_async<4 * kUnit>(a_dst + slot + 4 * STEP * j * TX_A_PITCH,
                          ok ? a_src + k0 + j * step : m2, ok ? 4 * kUnit : 0);
    }
#pragma unroll
    for (int j = 0; j < TX_NR / STEP; ++j) {
      const bool ok = k_ok && r0 + row0 + STEP * j < M;
      cp_async<4 * kUnit>(b_dst + slot + 16 * STEP * j, ok ? b_src + k0 + j * step : e,
                          ok ? 4 * kUnit : 0);
    }
  };
  for (int s = 0; s < TX_STAGES - 1; ++s) {
    if (s < n_k) fill(s);
    cp_async_commit();
  }
  float acc[TX_NR / 2];
#pragma unroll
  for (int i = 0; i < TX_NR / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < n_k; ++s) {
    cp_async_wait<TX_STAGES - 2>();
    // cp.async wrote the stage through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* slot = smem + (s % TX_STAGES) * TX_STAGE_FLOATS;
    uint32_t a[TX_KS / 8][3][4];  // k-step, part (hi, mid, lo), fragment
#pragma unroll
    for (int kk = 0; kk < TX_KS / 8; ++kk) {
      const float* row = slot + (64 * wg + 16 * warp + g) * TX_A_PITCH + 8 * kk + t;
      const float x[4] = {row[0], row[8 * TX_A_PITCH], row[4], row[8 * TX_A_PITCH + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split3(x[i], a[kk][0][i], a[kk][1][i], a[kk][2][i]);
    }
    const uint32_t b0 = smem_u32(slot + TX_A_FLOATS);
    tx_pin(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TX_KS / 8; ++kk) {
      const uint64_t desc = tx_desc(b0 + 4 * 2 * kk * TX_B_CHUNK);
      tx_wgmma(acc, a[kk][2], desc);
      tx_wgmma(acc, a[kk][1], desc);
      tx_wgmma(acc, a[kk][0], desc);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the slot of stage s - 1, whose products every thread waited for
    if (s + TX_STAGES - 1 < n_k) fill(s + TX_STAGES - 1);
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tx_pin(acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* tile = smem;  // [TX_NR][TX_OUT_PITCH]: row of E by pixel
#pragma unroll
  for (int j = 0; j < TX_NR / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 64 * wg + 16 * warp + g + 8 * h, n = 8 * j + 2 * t;
      tile[n * TX_OUT_PITCH + px] = acc[4 * j + 2 * h];
      tile[(n + 1) * TX_OUT_PITCH + px] = acc[4 * j + 2 * h + 1];
    }
  __syncthreads();
  const int n_rows = min(TX_NR, M - r0), n_px = min(TX_PX, P - p0);
  for (int i = threadIdx.x; i < TX_NR * TX_PX; i += TX_THREADS) {
    const int n = i / TX_PX, px = i % TX_PX;
    if (n < n_rows && px < n_px)
      lanes[(size_t)(r0 + n) * P + p0 + px] = tile[n * TX_OUT_PITCH + px];
  }
  if (!kBack) return;
  for (int i = threadIdx.x; i < TX_PX * TX_NR; i += TX_THREADS) {
    const int px = i / TX_NR, n = i % TX_NR;
    if (n < n_rows && px < n_px)
      back[(size_t)(p0 + px) * M + r0 + n] = tile[n * TX_OUT_PITCH + px];
  }
}

template <bool kBack, int kUnit>
cudaError_t tx_launch(const float* m2, const float* e, int P, int K, int M, float* lanes,
                      float* back, cudaStream_t stream) {
  // once an instance, before any capture into a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      transpose_wgmma_kernel<kBack, kUnit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TX_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((P + TX_PX - 1) / TX_PX, (M + TX_NR - 1) / TX_NR);
  transpose_wgmma_kernel<kBack, kUnit><<<grid, TX_THREADS, TX_BYTES, stream>>>(m2, e, P, K, M,
                                                                              lanes, back);
  return cudaGetLastError();
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

// banded dot, batched: a block of BD_THREADS computes the BD_M x BD_N tile
// of O[y] at rows r0.., columns c0.. over all of K = T, in chunks of BD_K:
// - B[y]'s tile rows (BD_M x BD_K) and S[y]'s (BD_K x BD_N) are staged in
//   shared memory once a chunk, by 16-byte cp.async (kV = 4: T and C
//   multiples of 4 floats, so every row of B and of S starts on 16 bytes,
//   and 16-byte bases) or 4-byte ones (kV = 1), zero-filled past T and C. 360 blocks at the script's shapes, three to an SM: one wave, all
//   of its loads in flight at once.
// - Warp w owns columns 16 w .. 16 w + 15 of the tile and all its BD_M rows
//   (4 row tiles x 2 column tiles of mma.sync m16n8k8 TF32): each S value is
//   loaded and split into its three TF32 parts once, by one lane, and
//   multiplies four row tiles of B (exact in TF32: 0/1); the products lo,
//   mid, hi go into one fp32 accumulator in that order, a k-step of 8 at a
//   time (probes.banded_mma_model is its plain model).
// - The tile is staged in shared memory and written in coalesced 16-byte
//   stores (4-byte ones for kV = 1).
constexpr int BD_M = 64, BD_N = 128, BD_K = 64, BD_THREADS = 256;
// staged B and S rows: pitches at which the fragments' loads hit 32 banks
constexpr int BD_B_PITCH = BD_K + 4, BD_S_PITCH = BD_N + 8;
constexpr int BD_B_FLOATS = BD_M * BD_B_PITCH;
constexpr int BD_BYTES = 4 * (BD_B_FLOATS + BD_K * BD_S_PITCH);
static_assert(BD_M <= BD_K, "the output tile fits S's staging");
static_assert(BD_N == 16 * (BD_THREADS / 32) && BD_M % 16 == 0, "a warp's 16 columns");

template <int kV>
__global__ void __launch_bounds__(BD_THREADS, 3)
banded_mma_kernel(const float* __restrict__ bm, const float* __restrict__ s, int T, int C,
                  int n_ct, float* __restrict__ o) {
  extern __shared__ __align__(128) float smem[];
  float* bs = smem;                // [BD_M][BD_B_PITCH]: B rows r0.., columns k0..
  float* ss = smem + BD_B_FLOATS;  // [BD_K][BD_S_PITCH]: S rows k0.., columns c0..
  const int y = blockIdx.x / n_ct, c0 = blockIdx.x % n_ct * BD_N, r0 = blockIdx.y * BD_M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* by = bm + (size_t)y * T * T;
  const float* sy = s + (size_t)y * T * C;
  const uint32_t bs_u32 = smem_u32(bs), ss_u32 = smem_u32(ss);
  float acc[BD_M / 16][2][4] = {};
#pragma unroll 1
  for (int k0 = 0; k0 < T; k0 += BD_K) {
    if (k0) __syncthreads();  // every warp is done with the last chunk
    for (int e = threadIdx.x; e < BD_M * BD_K / kV; e += BD_THREADS) {
      const int i = e / (BD_K / kV), k = e % (BD_K / kV) * kV;
      const bool ok = r0 + i < T && k0 + k < T;
      cp_async<4 * kV>(bs_u32 + 4 * (i * BD_B_PITCH + k),
                       ok ? by + (size_t)(r0 + i) * T + k0 + k : bm, ok ? 4 * kV : 0);
    }
    for (int e = threadIdx.x; e < BD_K * BD_N / kV; e += BD_THREADS) {
      const int k = e / (BD_N / kV), c = e % (BD_N / kV) * kV;
      const bool ok = k0 + k < T && c0 + c < C;
      cp_async<4 * kV>(ss_u32 + 4 * (k * BD_S_PITCH + c),
                       ok ? sy + (size_t)(k0 + k) * C + c0 + c : s, ok ? 4 * kV : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < BD_K; kk += 8) {
      uint32_t part[3][2][2];  // (lo, mid, hi), column tile, b fragment
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split3(ss[(kk + t + 4 * h) * BD_S_PITCH + 16 * warp + 8 * j + g], part[2][j][h],
                 part[1][j][h], part[0][j][h]);
#pragma unroll
      for (int mt = 0; mt < BD_M / 16; ++mt) {
        const float* row = bs + (16 * mt + g) * BD_B_PITCH + kk + t;
        const uint32_t a[4] = {to_tf32(row[0]), to_tf32(row[8 * BD_B_PITCH]), to_tf32(row[4]),
                               to_tf32(row[8 * BD_B_PITCH + 4])};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 3; ++q) mma_tf32(acc[mt][j], a, part[q][j]);
      }
    }
  }
  __syncthreads();
  float* tile = ss;  // [BD_M][BD_S_PITCH]
#pragma unroll
  for (int mt = 0; mt < BD_M / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (16 * mt + g + 8 * h) * BD_S_PITCH + 16 * warp +
                                   8 * j + 2 * t) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  __syncthreads();
  float* oy = o + (size_t)y * T * C;
  for (int e = threadIdx.x; e < BD_M * BD_N / kV; e += BD_THREADS) {
    const int i = e / (BD_N / kV), c = e % (BD_N / kV) * kV;
    if (r0 + i >= T || c0 + c >= C) continue;
    float* dst = oy + (size_t)(r0 + i) * C + c0 + c;
    if (kV == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(tile + i * BD_S_PITCH + c);
    else
      *dst = tile[i * BD_S_PITCH + c];
  }
}

template <int kV>
cudaError_t bd_launch(const float* b, const float* s, int Y, int T, int C, float* out,
                      cudaStream_t stream) {
  // once an instance, before any capture into a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      banded_mma_kernel<kV>, cudaFuncAttributeMaxDynamicSharedMemorySize, BD_BYTES);
  if (attr != cudaSuccess) return attr;
  const int n_ct = (C + BD_N - 1) / BD_N;
  banded_mma_kernel<kV><<<dim3(Y * n_ct, (T + BD_M - 1) / BD_M), BD_THREADS, BD_BYTES, stream>>>(
      b, s, T, C, n_ct, out);
  return cudaGetLastError();
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

// transpose A (back != nullptr) or D (back == nullptr): any P, K and M;
// exact where every row of expand is one-hot
extern "C" int bcd_probe_transpose_mma(const float* m2, const float* expand, int P, int K, int M,
                                       float* lanes, float* back, void* stream) {
  if (P <= 0 || K <= 0 || M <= 0 || (M + TX_NR - 1) / TX_NR > 65535)
    return (int)cudaErrorInvalidValue;
  const bool pairs = K % 2 == 0 && reinterpret_cast<uintptr_t>(m2) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(expand) % 8 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (back)
    return (int)(pairs ? tx_launch<true, 2>(m2, expand, P, K, M, lanes, back, st)
                       : tx_launch<true, 1>(m2, expand, P, K, M, lanes, back, st));
  return (int)(pairs ? tx_launch<false, 2>(m2, expand, P, K, M, lanes, nullptr, st)
                     : tx_launch<false, 1>(m2, expand, P, K, M, lanes, nullptr, st));
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

// any Y, T and C; 16-byte copies and stores where T and C are multiples of
// 4 and b, s and out start on 16 bytes
extern "C" int bcd_probe_banded_mma(const float* b, const float* s, int Y, int T, int C,
                                    float* out, void* stream) {
  if (Y <= 0 || T <= 0 || C <= 0 || (T + BD_M - 1) / BD_M > 65535 ||
      (long long)Y * ((C + BD_N - 1) / BD_N) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool vec = T % 4 == 0 && C % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec ? bd_launch<4>(b, s, Y, T, C, out, st) : bd_launch<1>(b, s, Y, T, C, out, st));
}

extern "C" int bcd_probe_banded_loop(const float* b, const float* s, int Y, int T, int C,
                                     int band, float* out, void* stream) {
  if (Y <= 0 || T <= 0 || C <= 0 || band < 0) return (int)cudaErrorInvalidValue;
  banded_loop_kernel<<<dim3((C + 255) / 256, T, Y), 256, 0, (cudaStream_t)stream>>>(
      b, s, T, C, band, out);
  return (int)cudaGetLastError();
}
