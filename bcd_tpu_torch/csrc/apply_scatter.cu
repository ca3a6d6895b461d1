// K4 of the fused denoiser: filter application and patch aggregation.
//
// Replaces bcd_tpu/ops/fused_pallas.py::apply_scatter2 (TPU kernel body
// _apply_scatter2_kernel). For a batch of tiles, every candidate position z
// of the band [h-b, h+t+b)^2 gathers the filtered patches that the core
// centers c = z - o of its similar sets deposit there:
//   F[z] = sum_o w[c, o] (A2[c] cpatch[z] + b2[c]) + fb[z] m[z],
//   cnt[z] = sum_o w[c, o] + fb[z],     w = mask * main-path gate,
// then every slab pixel y takes component group q of F[y - q] over the
// 3 x 3 patch offsets q: out (N, tp, tp, 4) = [color sums, estimate counts],
// apron included, for the overlap-add.
//
// What bounds it on an H100. The function needs 757 multiply-adds a
// selected (candidate, source) pair: about 16 G a 128-tile batch of the
// engine's t = 32, b = 6, 0.49 ms at the fp32 rate. The first port gave
// each (candidate, component) a thread that walked every selecting
// source's 27 x 27 filter from global memory: each filter (2.9 KB) was
// read once per candidate that selects it, up to 169 times, about 65 GB of
// L2 requests a batch, and the kernel ran at the L2's rate (12 ms).
//
// The design is the TPU kernel's WA-accumulation:
//   WA[z] = sum_o w[z-o, o] S[z-o],   S[c] = [A2^T[c] (729) | b2[c] (27) | 1],
// then F[z] = WA[z]'s 27 x 27 block times cpatch[z] plus its b2 and count
// channels. The sum over a source's filter is taken once per pair (one
// multiply-add per channel), the mat-vec once per candidate.
//   - wa_filter_kernel: a block owns R = 2 candidate rows of one tile and
//     walks the source columns left to right. Thread g holds channels g
//     and g + 384 of S; for each source column it reads the R + 2b source
//     rows within reach once (coalesced across the block's threads), and
//     each value feeds R x (2b + 1) accumulators in registers: the
//     candidates of its two rows within the window. The accumulators form
//     a sliding window over the candidate columns: after source column cx,
//     candidate cx has all its sources, leaves the window and the window
//     shifts. A source filter is read about (R + 2b) / R = 7 times a tile
//     instead of up to 169, about 3.8 GB a batch.
//   - The 0/1 weights mask * gate of the sources in reach are staged in
//     shared memory as floats, 4 source columns at a time (read as
//     16-byte broadcasts); a source off the main path, or outside the
//     tile, is skipped by the whole block.
//   - Every 4 candidate columns the finished WA rows go through shared
//     memory, and one thread per (candidate, output channel) forms
//     F = WA cpatch + wb (+ the fallback mean patch) in a fixed order.
//   - A search radius over 8 (2b + 1 > 17 columns, more than the registers
//     hold) runs in passes over blocks of the offsets, at most 17 x 17
//     each (ceil((2b + 1) / 17)^2 passes, windows of equal odd width):
//     each pass walks the sources again with the offsets of its block and
//     adds its share of F, which is linear in WA, to the earlier passes'
//     (the first pass stores, with the fallback). At b <= 8 there is one
//     pass over all offsets.
//   - fan_out_kernel sums the 3 x 3 patch groups per pixel.
// No atomics: every sum has a fixed order, so the output is bitwise
// deterministic from run to run, and the counts are sums of 0/1 weights,
// exact. The summation order differs from the twin's (the filters are
// summed before they are applied), so the sums agree to rounding.
//
// Layouts (bcd_tpu_torch/ops/fused.py): masks (N, t*t, O) uint8; a2t
// (N, t*t, 729) with a2t[k * 27 + j] = A2[j][k]; small (N, t*t, 56) =
// [b2 27 | gate | fb * m 27 | fb]; color (N, tp, tp, 3); F scratch
// (N, (t+2b)^2, 28) = [field 27 | count].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 27;
constexpr int SMALL_CH = 56;
constexpr int FCH = D + 1;
constexpr int NCH = D * D + D + 1;  // [A2^T | b2 | 1]
constexpr int THREADS = 384;        // channels g and g + 384 a thread
constexpr int NCH_PAD = 2 * THREADS;
constexpr int R = 2;                // candidate rows a block
constexpr int PERIOD = 4;           // source columns staged at once
constexpr int MAX_NW = 17;          // widest window a pass holds in registers

// One pass over the offsets dy in [dy0, dy0 + NW), dx in [dx0, dx0 + NW)
// (those below nd = 2b + 1). acc[r][i] is the candidate of row zy0 + r and
// column s + i at step s, which takes source column cx = s - dx0 (offset
// dx = dx0 + i); after it, candidate column s has its sources of the pass.
template <int NW>
__global__ void __launch_bounds__(THREADS, 2)
wa_filter_kernel(const uint8_t* __restrict__ masks, const float* __restrict__ a2t,
                 const float* __restrict__ small, const float* __restrict__ color,
                 int tp, int t, int h, int nd, int dy0, int dx0,
                 float* __restrict__ F) {
  constexpr int NU = R + NW - 1;  // source rows within reach of the block
  constexpr int WSTRIDE = 4 * ((NW + 3) / 4);
  __shared__ __align__(16) float wsh[NU][R][PERIOD][WSTRIDE];
  __shared__ int live[NU][PERIOD];
  __shared__ __align__(16) float ring[PERIOD][R][NCH_PAD];
  const int B = nd / 2, E = t + 2 * B;
  const bool first = dy0 == 0 && dx0 == 0;
  const int zy0 = blockIdx.x * R, n = blockIdx.y;
  const int cy0 = zy0 - dy0 - (NW - 1);  // tile row of source row u = 0
  const int g = threadIdx.x;
  const size_t tile0 = (size_t)n * t * t;

  // channel g is an A2^T entry; channel g + 384 an A2^T entry, a b2 entry,
  // the count (a constant 1) or padding (0)
  const int ch1 = g + THREADS;
  const float* src1 = nullptr;
  int stride1 = 0;
  float const1 = 0.f;
  if (ch1 < D * D) {
    src1 = a2t + ch1;
    stride1 = D * D;
  } else if (ch1 < D * D + D) {
    src1 = small + (ch1 - D * D);
    stride1 = SMALL_CH;
  } else {
    const1 = ch1 == D * D + D ? 1.f : 0.f;
  }

  float acc[R][NW][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NW; ++i) acc[r][i][0] = acc[r][i][1] = 0.f;

  for (int c0 = 0; c0 < E; c0 += PERIOD) {
    // weights of steps [c0, c0 + PERIOD): wsh[u][r][col][dx] is w of
    // source (cy0 + u, c0 + col - dx0) toward candidate row zy0 + r,
    // column c0 + col + dx
    for (int i = g; i < NU * R * PERIOD * WSTRIDE; i += THREADS) {
      const int dx = i % WSTRIDE, col = (i / WSTRIDE) % PERIOD;
      const int r = (i / (WSTRIDE * PERIOD)) % R, u = i / (WSTRIDE * PERIOD * R);
      const int cy = cy0 + u, cx = c0 + col - dx0, dy = NW - 1 - u + r;
      float w = 0.f;
      if (dx < NW && dx0 + dx < nd && dy >= 0 && dy < NW && dy0 + dy < nd &&
          cy >= 0 && cy < t && cx >= 0 && cx < t) {
        const size_t pc = tile0 + (size_t)cy * t + cx;
        if (small[pc * SMALL_CH + D] != 0.f &&
            masks[pc * nd * nd + (dy0 + dy) * nd + dx0 + dx])
          w = 1.f;
      }
      (&wsh[0][0][0][0])[i] = w;
    }
    for (int i = g; i < NU * PERIOD; i += THREADS) {
      const int u = i / PERIOD, col = i % PERIOD;
      const int cy = cy0 + u, cx = c0 + col - dx0;
      live[u][col] = cy >= 0 && cy < t && cx >= 0 && cx < t &&
                     small[(tile0 + (size_t)cy * t + cx) * SMALL_CH + D] != 0.f;
    }
    __syncthreads();

    for (int col = 0; col < PERIOD; ++col) {
      if (c0 + col >= E) break;
      const int cx = c0 + col - dx0;
      for (int u = 0; u < NU; ++u) {
        if (!live[u][col]) continue;
        const size_t pc = tile0 + (size_t)(cy0 + u) * t + cx;
        const float s0 = __ldg(a2t + pc * (D * D) + g);
        const float s1 = src1 ? __ldg(src1 + pc * stride1) : const1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dy = NW - 1 - u + r;
          if (dy < 0 || dy >= NW) continue;
          const float4* w4 = reinterpret_cast<const float4*>(wsh[u][r][col]);
#pragma unroll
          for (int k = 0; k < WSTRIDE / 4; ++k) {
            const float4 w = w4[k];
            const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (4 * k + e < NW) {
                acc[r][4 * k + e][0] = fmaf(wv[e], s0, acc[r][4 * k + e][0]);
                acc[r][4 * k + e][1] = fmaf(wv[e], s1, acc[r][4 * k + e][1]);
              }
            }
          }
        }
      }
      // candidate column c0 + col has all its sources: out of the window
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ring[col][r][g] = acc[r][0][0];
        ring[col][r][ch1] = acc[r][0][1];
#pragma unroll
        for (int i = 0; i + 1 < NW; ++i) {
          acc[r][i][0] = acc[r][i + 1][0];
          acc[r][i][1] = acc[r][i + 1][1];
        }
        acc[r][NW - 1][0] = acc[r][NW - 1][1] = 0.f;
      }
    }
    __syncthreads();

    // F = WA cpatch + wb (+ the fallback mean patch), count = WA's count
    // channel (+ fb), one thread per (candidate, output channel); a later
    // pass adds its share
    for (int i = g; i < PERIOD * R * FCH; i += THREADS) {
      const int j = i % FCH, col = (i / FCH) % PERIOD, r = i / (FCH * PERIOD);
      const int zy = zy0 + r, zx = c0 + col;
      if (zy >= E || zx >= E) continue;
      const float* wa = ring[col][r];
      float f;
      if (j < D) {
        const int sy = h - B + zy, sx = h - B + zx;
        f = 0.f;
#pragma unroll 9
        for (int k = 0; k < D; ++k) {
          const int qi = k / 3;
          const int yy = sy + qi / 3 - 1, xx = sx + qi % 3 - 1;
          f = fmaf(color[(((size_t)n * tp + yy) * tp + xx) * 3 + k % 3], wa[k * D + j], f);
        }
        f += wa[D * D + j];
      } else {
        f = wa[D * D + D];
      }
      float* out = F + ((size_t)n * E * E + (size_t)zy * E + zx) * FCH + j;
      if (!first) {
        *out += f;
        continue;
      }
      // a fallback center deposits its mean patch at its own position only
      const int cy = zy - B, cx = zx - B;
      if (cy >= 0 && cy < t && cx >= 0 && cx < t) {
        const float* sm = small + (tile0 + (size_t)cy * t + cx) * SMALL_CH;
        f += (j < D) ? sm[D + 1 + j] : sm[2 * D + 1];
      }
      *out = f;
    }
  }
}

__global__ void fan_out_kernel(const float* __restrict__ F, int n_tiles, int tp,
                               int t, int h, int b, float* __restrict__ out) {
  const int E = t + 2 * b;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_tiles * tp * tp) return;
  const int n = (int)(idx / ((size_t)tp * tp));
  const int rem = (int)(idx % ((size_t)tp * tp));
  const int y = rem / tp, x = rem % tp;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, cnt = 0.f;
  for (int qi = 0; qi < 9; ++qi) {
    const int zy = y - (qi / 3 - 1) - (h - b), zx = x - (qi % 3 - 1) - (h - b);
    if (zy < 0 || zy >= E || zx < 0 || zx >= E) continue;
    const float* f = F + ((size_t)n * E * E + (size_t)zy * E + zx) * FCH;
    s0 += f[3 * qi];
    s1 += f[3 * qi + 1];
    s2 += f[3 * qi + 2];
    cnt += f[D];
  }
  float* o = out + idx * 4;
  o[0] = s0;
  o[1] = s1;
  o[2] = s2;
  o[3] = cnt;
}

// the passes of one window width, in a fixed order
template <int NW>
void launch_wa(const uint8_t* masks, const float* a2t, const float* small,
               const float* color, int n_tiles, int tp, int t, int h, int nd,
               float* F, cudaStream_t s) {
  const int E = t + nd - 1;
  for (int dy0 = 0; dy0 < nd; dy0 += NW)
    for (int dx0 = 0; dx0 < nd; dx0 += NW)
      wa_filter_kernel<NW><<<dim3((E + R - 1) / R, n_tiles), THREADS, 0, s>>>(
          masks, a2t, small, color, tp, t, h, nd, dy0, dx0, F);
}

// The window: 2b + 1 where that fits (b <= 8), else the odd width that
// covers 2b + 1 in the fewest passes
int window(int nd) {
  const int passes = (nd + MAX_NW - 1) / MAX_NW;
  return ((nd + passes - 1) / passes) | 1;
}

}  // namespace

extern "C" int bcd_apply_scatter(const unsigned char* masks, const float* a2t,
                                 const float* small, const float* color,
                                 int n_tiles, int t, int h, int b, float* F,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tp = t + 2 * h, nd = 2 * b + 1;
  if (b < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    switch (window(nd)) {
      case 3: launch_wa<3>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      case 5: launch_wa<5>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      case 7: launch_wa<7>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      case 9: launch_wa<9>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      case 11: launch_wa<11>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      case 13: launch_wa<13>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      case 15: launch_wa<15>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
      default: launch_wa<17>(masks, a2t, small, color, n_tiles, tp, t, h, nd, F, s); break;
    }
    const size_t total = (size_t)n_tiles * tp * tp;
    fan_out_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        F, n_tiles, tp, t, h, b, out);
  }
  return (int)cudaGetLastError();
}
