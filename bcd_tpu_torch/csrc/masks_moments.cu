// K1 of the fused denoiser: similar-patch masks and masked patch moments.
//
// Replaces bcd_tpu/ops/fused_pallas.py::masks_moments2 (TPU kernel body
// _masks_moments2_kernel). For a batch of halo-padded tiles (slab side
// tp = t + 2h, h >= b + 1) and each core center p and window offset o
// ((2b+1)^2 of them, row-major in (dy, dx)):
//   chi^2 patch distance: per pixel pair (y, y + o), bins with
//   h1 + h2 > 1 add (n2 h1 - n1 h2)^2 / (n1 n2 (h1 + h2)) (a zero
//   denominator counts as 1); numerators and kept-bin counts are summed
//   over the 3 x 3 patch; dist = num / cnt, or +inf when no bin is kept;
//   mask = dist <= thr & candidate interior & center_valid, with the self
//   offset always on for valid centers;
//   masked sums over the similar set of the patch outer products (upper
//   triangle, 378), the color patches (27), the patch pixel covariances
//   (54) and the set size n.
//
// What bounds it on an H100: the chi^2 pass, 169 offsets x (t+2)^2 pixels x
// nbins bins, each bin a division, with every histogram read from L1/L2
// once per offset; then the moment pass, t^2 x 460 channels x 169 offsets of
// shared-memory multiply-adds.
// The design: two kernels. chi2_pixels computes the per-pixel numerators
// and counts once per (tile, offset) into a scratch buffer, so no pixel pair
// is evaluated twice (a per-center kernel would evaluate each 9 times).
// masks_moments takes one row of centers per block: it box-sums the scratch
// into the row's 169 masks (kept in shared memory and written out), stages
// the color and pixel-covariance window the row's candidates reach in
// shared memory, and lets threads across the 460 moment channels loop over
// the offsets. The sums are plain fp32 sums of 0/1-weighted terms (no
// reduced precision), so n stays an exact integer.
//
// Layouts (bcd_tpu_torch/ops/fused.py): slabs (N, tp, tp, C); masks
// (N, t*t, O) uint8; m2 (N, t*t, 378) upper triangle row by row; misc
// (N, t*t, 83) = [msum 27 | nov 54 | n | center_valid]; chi scratch
// (N, O, 2, (t+2)^2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 27;
constexpr int NPX = 9;
constexpr int DTRI = D * (D + 1) / 2;
constexpr int MISC_CH = 83;
constexpr int NCH = DTRI + D + 6 * NPX + 1;  // accumulated channels
constexpr int WCH = 9;                       // window channels: color 3, pixcov 6

__global__ void chi2_pixels_kernel(const float* __restrict__ histo,
                                   const float* __restrict__ nb, int tp, int t,
                                   int h, int b, int nbins,
                                   float* __restrict__ chi) {
  const int nd = 2 * b + 1, n_off = nd * nd;
  const int o = blockIdx.x, n = blockIdx.y;
  const int dy = o / nd - b, dx = o % nd - b;
  const int e1 = t + 2, npix = e1 * e1;
  const float* H = histo + (size_t)n * tp * tp * nbins;
  const float* NB = nb + (size_t)n * tp * tp;
  float* out = chi + ((size_t)n * n_off + o) * 2 * npix;
  for (int i = threadIdx.x; i < npix; i += blockDim.x) {
    const int y = h - 1 + i / e1, x = h - 1 + i % e1;
    const int zc = y * tp + x, zn = (y + dy) * tp + (x + dx);
    const float nbc = NB[zc], nbn = NB[zn];
    const float* hc = H + (size_t)zc * nbins;
    const float* hn = H + (size_t)zn * nbins;
    float num = 0.f, cnt = 0.f;
    for (int k = 0; k < nbins; ++k) {
      const float a = hc[k], c = hn[k], hs = a + c;
      if (hs > 1.f) {
        const float diff = nbn * a - nbc * c;
        float den = nbc * nbn * hs;
        if (den == 0.f) den = 1.f;
        num += diff * diff / den;
        cnt += 1.f;
      }
    }
    out[i] = num;
    out[npix + i] = cnt;
  }
}

// window offset of color patch entry k = 3 * qi + c, relative to the
// patch's top-left window pixel
__device__ __forceinline__ int patch_off(int k, int w) {
  const int qi = k / 3;
  return ((qi / 3) * w + qi % 3) * WCH + k % 3;
}

__global__ void masks_moments_kernel(const float* __restrict__ chi,
                                     const float* __restrict__ color,
                                     const float* __restrict__ pixcov,
                                     const float* __restrict__ valid, float thr,
                                     int tp, int t, int h, int b,
                                     uint8_t* __restrict__ masks,
                                     float* __restrict__ m2,
                                     float* __restrict__ misc) {
  extern __shared__ float smem[];
  const int nd = 2 * b + 1, n_off = nd * nd, self = n_off / 2;
  const int yr = blockIdx.x, n = blockIdx.y;
  const int W = t + 2 * b + 2, R = 2 * b + 3;
  const int e1 = t + 2, npix = e1 * e1;
  float* win = smem;                          // R * W * WCH
  int* offa = (int*)(win + R * W * WCH);      // NCH
  int* offb = offa + NCH;                     // NCH
  uint8_t* msk = (uint8_t*)(offb + NCH);      // t * n_off
  const size_t slab = (size_t)n * tp * tp;
  const int py = h + yr;                      // slab row of the centers
  const int wy0 = py - b - 1, wx0 = h - b - 1;

  for (int i = threadIdx.x; i < R * W; i += blockDim.x) {
    const size_t z = slab + (size_t)(wy0 + i / W) * tp + (wx0 + i % W);
    float* w = win + i * WCH;
    for (int c = 0; c < 3; ++c) w[c] = color[z * 3 + c];
    for (int c = 0; c < 6; ++c) w[3 + c] = pixcov[z * 6 + c];
  }
  // channel -> window offsets of its two factors (-1: the constant 1)
  for (int ch = threadIdx.x; ch < NCH; ch += blockDim.x) {
    int a = -1, bo = -1;
    if (ch < DTRI) {
      int k = 0, base = 0;
      while (ch >= base + (D - k)) {
        base += D - k;
        ++k;
      }
      a = patch_off(k, W);
      bo = patch_off(k + (ch - base), W);
    } else if (ch < DTRI + D) {
      a = patch_off(ch - DTRI, W);
    } else if (ch < DTRI + D + 6 * NPX) {
      const int v = ch - DTRI - D, qi = v / 6;
      a = ((qi / 3) * W + qi % 3) * WCH + 3 + v % 6;
    }
    offa[ch] = a;
    offb[ch] = bo;
  }

  const float* V = valid + slab * 2;
  for (int i = threadIdx.x; i < t * n_off; i += blockDim.x) {
    const int o = i / t, x = i % t;
    const int px = h + x;
    const bool cv = V[((size_t)py * tp + px) * 2] > 0.f;
    bool on;
    if (o == self) {
      on = cv;
    } else {
      const int dy = o / nd - b, dx = o % nd - b;
      const float* cn = chi + ((size_t)n * n_off + o) * 2 * npix;
      float num = 0.f, cnt = 0.f;
      for (int qy = 0; qy < 3; ++qy)
        for (int qx = 0; qx < 3; ++qx) {
          const int bi = (yr + qy) * e1 + x + qx;
          num += cn[bi];
          cnt += cn[npix + bi];
        }
      const float dist = cnt > 0.f ? num / fmaxf(cnt, 1.f) : INFINITY;
      const bool interior = V[((size_t)(py + dy) * tp + px + dx) * 2 + 1] > 0.f;
      on = cv && interior && dist <= thr;
    }
    msk[x * n_off + o] = on;
    masks[(((size_t)n * t + yr) * t + x) * n_off + o] = on;
  }
  __syncthreads();

  const size_t prow = ((size_t)n * t + yr) * t;
  for (int i = threadIdx.x; i < t * NCH; i += blockDim.x) {
    const int x = i / NCH, ch = i % NCH;
    const int a = offa[ch], bo = offb[ch];
    const uint8_t* mrow = msk + x * n_off;
    float acc = 0.f;
    for (int dyi = 0; dyi < nd; ++dyi)
      for (int dxi = 0; dxi < nd; ++dxi) {
        if (!mrow[dyi * nd + dxi]) continue;
        // top-left window pixel of the candidate patch at center + o
        const float* base = win + (dyi * W + x + dxi) * WCH;
        const float va = a >= 0 ? base[a] : 1.f;
        const float vb = bo >= 0 ? base[bo] : 1.f;
        acc += va * vb;
      }
    if (ch < DTRI)
      m2[(prow + x) * DTRI + ch] = acc;
    else
      misc[(prow + x) * MISC_CH + (ch - DTRI)] = acc;
  }
  for (int x = threadIdx.x; x < t; x += blockDim.x)
    misc[(prow + x) * MISC_CH + MISC_CH - 1] =
        V[((size_t)py * tp + h + x) * 2] > 0.f ? 1.f : 0.f;
}

}  // namespace

extern "C" int bcd_masks_moments(const float* histo, const float* nb,
                                 const float* color, const float* pixcov,
                                 const float* valid, float thr, int n_tiles,
                                 int t, int h, int b, int nbins, float* chi,
                                 unsigned char* masks, float* m2, float* misc,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tp = t + 2 * h, nd = 2 * b + 1, n_off = nd * nd;
  if (n_tiles > 0) {
    chi2_pixels_kernel<<<dim3(n_off, n_tiles), 256, 0, s>>>(histo, nb, tp, t, h,
                                                            b, nbins, chi);
    const size_t smem = (size_t)(2 * b + 3) * (t + 2 * b + 2) * WCH * 4 +
                        2 * NCH * 4 + (size_t)t * n_off;
    cudaFuncSetAttribute(masks_moments_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    masks_moments_kernel<<<dim3(t, n_tiles), 256, smem, s>>>(
        chi, color, pixcov, valid, thr, tp, t, h, b, masks, m2, misc);
  }
  return (int)cudaGetLastError();
}
