// K4 of the fused denoiser: filter application and patch aggregation.
//
// Replaces bcd_tpu/ops/fused_pallas.py::apply_scatter2 (TPU kernel body
// _apply_scatter2_kernel). For a batch of tiles, every candidate position z
// of the band [h-b, h+t+b)^2 GATHERS the filtered patches that the core
// centers c = z - o of its similar sets deposit there:
//   F[z] = sum_o w[c, o] (A2[c] cpatch[z] + b2[c]) + fb[z] m[z],
//   cnt[z] = sum_o w[c, o] + fb[z],     w = mask * main-path gate,
// then every slab pixel y takes component group q of F[y - q] over the
// 3 x 3 patch offsets q: out (N, tp, tp, 4) = [color sums, estimate counts],
// apron included, for the overlap-add.
//
// What bounds it on an H100: the gather, up to 169 sources x 27 x 27
// multiply-adds per candidate, with each source's 27 x 27 filter (2.9 KB)
// read from L2 by every candidate that selects it.
// The design: filter_candidates takes one candidate row per block, stages
// the row's candidate color patches in shared memory and gives each thread
// one (candidate, component) output, looping over the offsets in a fixed
// order; consecutive threads read consecutive components of a source's
// filter. fan_out then sums the 3 x 3 patch groups per pixel. Both are
// gathers with a fixed summation order: no atomics, so the output is
// bitwise deterministic from run to run.
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

__global__ void filter_candidates_kernel(const uint8_t* __restrict__ masks,
                                         const float* __restrict__ a2t,
                                         const float* __restrict__ small,
                                         const float* __restrict__ color,
                                         int tp, int t, int h, int b,
                                         float* __restrict__ F) {
  extern __shared__ float cp[];  // E * 27 color patches of this candidate row
  const int nd = 2 * b + 1, n_off = nd * nd;
  const int E = t + 2 * b;
  const int zy = blockIdx.x, n = blockIdx.y;
  const int sy = h - b + zy;  // slab row of the candidates
  const float* col = color + (size_t)n * tp * tp * 3;
  for (int i = threadIdx.x; i < E * D; i += blockDim.x) {
    const int zx = i / D, k = i % D, qi = k / 3;
    const int yy = sy + qi / 3 - 1, xx = h - b + zx + qi % 3 - 1;
    cp[i] = col[((size_t)yy * tp + xx) * 3 + k % 3];
  }
  __syncthreads();
  const size_t tile0 = (size_t)n * t * t;
  for (int i = threadIdx.x; i < E * FCH; i += blockDim.x) {
    const int zx = i / FCH, j = i % FCH;
    const float* cz = cp + zx * D;
    float acc = 0.f;
    for (int dyi = 0; dyi < nd; ++dyi) {
      const int cy = zy - dyi;  // core row of the center z - o
      if (cy < 0 || cy >= t) continue;
      for (int dxi = 0; dxi < nd; ++dxi) {
        const int cx = zx - dxi;
        if (cx < 0 || cx >= t) continue;
        const size_t pc = tile0 + (size_t)cy * t + cx;
        if (!masks[pc * n_off + dyi * nd + dxi]) continue;
        const float* sm = small + pc * SMALL_CH;
        if (sm[D] == 0.f) continue;  // main-path gate
        if (j < D) {
          const float* at = a2t + pc * D * D + j;
          float f = sm[j];
          for (int k = 0; k < D; ++k) f += at[k * D] * cz[k];
          acc += f;
        } else {
          acc += 1.f;
        }
      }
    }
    // a fallback center deposits its mean patch at its own position only
    const int cy = zy - b, cx = zx - b;
    if (cy >= 0 && cy < t && cx >= 0 && cx < t) {
      const float* sm = small + (tile0 + (size_t)cy * t + cx) * SMALL_CH;
      acc += (j < D) ? sm[D + 1 + j] : sm[2 * D + 1];
    }
    F[((size_t)n * E * E + (size_t)zy * E + zx) * FCH + j] = acc;
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

}  // namespace

extern "C" int bcd_apply_scatter(const unsigned char* masks, const float* a2t,
                                 const float* small, const float* color,
                                 int n_tiles, int t, int h, int b, float* F,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tp = t + 2 * h, E = t + 2 * b;
  if (n_tiles > 0) {
    const size_t smem = (size_t)E * D * sizeof(float);
    filter_candidates_kernel<<<dim3(E, n_tiles), 256, smem, s>>>(
        masks, a2t, small, color, tp, t, h, b, F);
    const size_t total = (size_t)n_tiles * tp * tp;
    fan_out_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        F, n_tiles, tp, t, h, b, out);
  }
  return (int)cudaGetLastError();
}
