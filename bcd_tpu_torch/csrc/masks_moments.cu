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
// What bounds it on an H100. Operations: the chi^2 terms, each pixel pair
// once, 84 offsets x (t+2)^2 pixels x 60 bins x about 8 flops with a
// division (47 MFLOP a 32 x 32 tile), and the moments, at most 1024
// centers x 169 offsets x 460 channels x 2 (159 MFLOP a tile): at most 26
// GFLOP, 0.39 ms at 67 TFLOP/s of fp32 for a 128-tile batch
// (ops/bounds.py); bytes, 0.34 GB, 0.10 ms. So arithmetic bounds it. The
// first port missed that by 30x: a thread per pixel pair read its two
// 60-bin histograms with a 240-byte stride (32 sectors a warp load for 128
// useful bytes) and fetched every histogram again for each of the 169
// offsets (about 12 GB of L2 requests a batch), through a 200 MB scratch of
// per-pixel terms; its moment loop issued two shared loads and a mask byte
// per FMA.
//
// The design:
//   chi2_masks: one block per (tile, band of centers; chi_band picks the
//   largest square band, t split evenly, whose staging fits the 227 KB of
//   shared memory a block can opt into). It stages
//   the band's histograms with the +-(b+1) halo in shared memory once,
//   bins-major (neighbouring threads read neighbouring pixels; the plane
//   stride is odd, so the transposing writes spread over the banks), and
//   loops over the offsets inside the block: each histogram leaves L2 once
//   per block. The per-pixel term is symmetric, term_-o(z) = term_o(z - o),
//   so the block evaluates only the 84 offsets after the self offset, each
//   pixel pair once, over the bounding box of the band's patch pixels and
//   their mirror images, and box-sums the same numbers into the masks of o
//   and -o (which therefore cannot disagree by rounding). The 3 x 3 box sum
//   and the threshold run in the same block, so no per-pixel scratch goes
//   to memory: the masks leave as bytes (K4's input) and as bit rows,
//   ceil(O / 32) words a center, for the moment kernel.
//   moments: one warp per center, so the loop over its selected offsets
//   (the set bits of its mask row) is uniform. The 27 x 27 upper triangle
//   is cut into the 45 blocks of patch-pixel pairs (qa <= qb), 3 x 3
//   channels each; a lane owns one or two blocks and keeps their sums in
//   registers. Per selected offset it loads the two patch pixels' colors
//   (one 16-byte shared load each) and issues 9 FMAs a block; the lanes of
//   the 9 diagonal blocks also sum the color patch and the pixel
//   covariances. The sums are plain fp32 sums of 0/1-weighted terms (no
//   reduced precision), so n stays an exact integer.
//
// Layouts (bcd_tpu_torch/ops/fused.py): slabs (N, tp, tp, C); masks
// (N, t*t, O) uint8; mask bits (N, t*t, ceil(O / 32)) uint32; m2
// (N, t*t, 378) upper triangle row by row; misc (N, t*t, 83) =
// [msum 27 | nov 54 | n | center_valid].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 27;
constexpr int NPX = 9;
constexpr int DTRI = D * (D + 1) / 2;
constexpr int MISC_CH = 83;
constexpr int CHI_THREADS = 512;
constexpr int MOM_WARPS = 8;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can opt into

struct ChiGeometry {
  int sr, sc, plane, bb, nw;  // staged rows, cols, bin-plane stride, box, words
  size_t bytes;
};

__host__ __device__ inline ChiGeometry chi_geometry(int b, int nbins, int bh,
                                                    int bw) {
  ChiGeometry g;
  g.sr = bh + 2 + 2 * b;
  g.sc = bw + 2 + 2 * b;
  g.plane = (g.sr * g.sc) | 1;
  g.bb = (bh + 2 + b) * (bw + 2 + b);  // largest bounding box of one offset
  g.nw = ((2 * b + 1) * (2 * b + 1) + 31) / 32;
  g.bytes = 4 * ((size_t)nbins * g.plane + (size_t)g.sr * g.sc + 2 * g.bb +
                 (size_t)bh * bw * g.nw);
  return g;
}

__global__ void __launch_bounds__(CHI_THREADS)
chi2_masks_kernel(const float* __restrict__ histo, const float* __restrict__ nb,
                  const float* __restrict__ valid, float thr, int tp, int t,
                  int h, int b, int nbins, int bh, int bw,
                  uint8_t* __restrict__ masks, uint32_t* __restrict__ bits_out) {
  extern __shared__ float smem[];
  const ChiGeometry g = chi_geometry(b, nbins, bh, bw);
  const int nd = 2 * b + 1, n_off = nd * nd, self = n_off / 2, nw = g.nw;
  const int tid = threadIdx.x;
  const int bands_x = (t + bw - 1) / bw;
  const int y0 = (blockIdx.x / bands_x) * bh, x0 = (blockIdx.x % bands_x) * bw;
  const int n = blockIdx.y;
  const int nh = min(bh, t - y0), nwd = min(bw, t - x0);  // centers here
  const int R = nh + 2, Cc = nwd + 2;  // patch pixels of those centers
  const int sr = R + 2 * b, sc = Cc + 2 * b, SC = g.sc;
  float* hs = smem;                           // nbins planes, bins-major
  float* nbs = hs + (size_t)nbins * g.plane;  // sample counts, stride SC
  float* num = nbs + g.sr * g.sc;             // one offset's terms
  float* cnt = num + g.bb;
  uint32_t* bits = (uint32_t*)(cnt + g.bb);   // the band's mask rows

  // staged pixel (r, c) is slab pixel (gy0 + r, gx0 + c)
  const int gy0 = h + y0 - 1 - b, gx0 = h + x0 - 1 - b;
  const size_t slab = (size_t)n * tp * tp;
  for (int i = tid; i < sr * sc * nbins; i += CHI_THREADS) {
    const int k = i % nbins, pix = i / nbins;
    const int r = pix / sc, c = pix % sc;
    hs[k * g.plane + r * SC + c] =
        histo[(slab + (size_t)(gy0 + r) * tp + gx0 + c) * nbins + k];
  }
  for (int i = tid; i < sr * sc; i += CHI_THREADS) {
    const int r = i / sc, c = i % sc;
    nbs[r * SC + c] = nb[slab + (size_t)(gy0 + r) * tp + gx0 + c];
  }
  for (int i = tid; i < nh * nwd * nw; i += CHI_THREADS) bits[i] = 0u;
  __syncthreads();

  const float* V = valid + slab * 2;
  const int ncen = nh * nwd;
  for (int o = self + 1; o < n_off; ++o) {
    const int dy = o / nd - b, dx = o % nd - b;  // dy >= 0
    // bounding box of the patch pixels (staged rows [b, b + R), cols
    // [b, b + Cc)) and of their images under -o
    const int br0 = b - dy, bc0 = b - max(dx, 0);
    const int bC = Cc + abs(dx), bn = (R + dy) * bC;
    for (int i = tid; i < bn; i += CHI_THREADS) {
      const int zc = (br0 + i / bC) * SC + bc0 + i % bC;
      const int zn = zc + dy * SC + dx;
      const float nbc = nbs[zc], nbn = nbs[zn];
      const float nn = nbc * nbn;
      float nu = 0.f, ct = 0.f;
      for (int k = 0; k < nbins; ++k) {
        const float a = hs[k * g.plane + zc], c = hs[k * g.plane + zn];
        const float hsum = a + c;
        if (hsum > 1.f) {
          const float diff = nbn * a - nbc * c;
          float den = nn * hsum;
          if (den == 0.f) den = 1.f;
          nu += diff * diff / den;
          ct += 1.f;
        }
      }
      num[i] = nu;
      cnt[i] = ct;
    }
    __syncthreads();
    // masks of o (patch pixels of the center) and -o (their images)
    for (int i = tid; i < 2 * ncen; i += CHI_THREADS) {
      const bool neg = i >= ncen;
      const int ci = neg ? i - ncen : i;
      const int y = ci / nwd, x = ci % nwd;
      const int ody = neg ? -dy : dy, odx = neg ? -dx : dx;
      const int r0 = b + y - (neg ? dy : 0) - br0;  // box's top-left
      const int c0 = b + x - (neg ? dx : 0) - bc0;
      float nu = 0.f, ct = 0.f;
      for (int qy = 0; qy < 3; ++qy)
        for (int qx = 0; qx < 3; ++qx) {
          const int bi = (r0 + qy) * bC + c0 + qx;
          nu += num[bi];
          ct += cnt[bi];
        }
      const float dist = ct > 0.f ? nu / fmaxf(ct, 1.f) : INFINITY;
      const int py = h + y0 + y, px = h + x0 + x;
      const bool cv = V[((size_t)py * tp + px) * 2] > 0.f;
      const bool interior =
          V[((size_t)(py + ody) * tp + px + odx) * 2 + 1] > 0.f;
      if (cv && interior && dist <= thr) {
        const int oo = neg ? n_off - 1 - o : o;
        atomicOr(&bits[ci * nw + oo / 32], 1u << (oo % 32));
      }
    }
    __syncthreads();
  }
  for (int ci = tid; ci < ncen; ci += CHI_THREADS) {  // the self offset
    const int py = h + y0 + ci / nwd, px = h + x0 + ci % nwd;
    if (V[((size_t)py * tp + px) * 2] > 0.f)
      atomicOr(&bits[ci * nw + self / 32], 1u << (self % 32));
  }
  __syncthreads();
  for (int i = tid; i < ncen * n_off; i += CHI_THREADS) {
    const int ci = i / n_off, o = i % n_off;
    const size_t c = ((size_t)n * t + y0 + ci / nwd) * t + x0 + ci % nwd;
    masks[c * n_off + o] = (bits[ci * nw + o / 32] >> (o % 32)) & 1u;
  }
  for (int i = tid; i < ncen * nw; i += CHI_THREADS) {
    const int ci = i / nw;
    const size_t c = ((size_t)n * t + y0 + ci / nwd) * t + x0 + ci % nwd;
    bits_out[c * nw + i % nw] = bits[i];
  }
}

// the block (qa, qb) of patch-pixel pairs that lane `lane` owns: blocks
// 0-8 are the diagonal (q, q), 9-44 the pairs qa < qb in row order; lane L
// owns block L, and lanes 9-21 also block L + 23 (32-44)
__device__ __forceinline__ int2 block_of(int blk) {
  if (blk < NPX) return make_int2(blk, blk);
  int e = blk - NPX, qa = 0;
  while (e >= NPX - 1 - qa) {
    e -= NPX - 1 - qa;
    ++qa;
  }
  return make_int2(qa, qa + 1 + e);
}

__device__ __forceinline__ int tri_index(int k, int j) {  // k <= j
  return k * D - k * (k - 1) / 2 + (j - k);
}

__device__ __forceinline__ void outer3(float (&acc)[9], float4 a, float4 c) {
  acc[0] = fmaf(a.x, c.x, acc[0]);
  acc[1] = fmaf(a.x, c.y, acc[1]);
  acc[2] = fmaf(a.x, c.z, acc[2]);
  acc[3] = fmaf(a.y, c.x, acc[3]);
  acc[4] = fmaf(a.y, c.y, acc[4]);
  acc[5] = fmaf(a.y, c.z, acc[5]);
  acc[6] = fmaf(a.z, c.x, acc[6]);
  acc[7] = fmaf(a.z, c.y, acc[7]);
  acc[8] = fmaf(a.z, c.z, acc[8]);
}

__device__ __forceinline__ void store_block(float* m2row, const float (&acc)[9],
                                            int qa, int qb) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = 3 * qa + i, l = 3 * qb + j;
      if (k <= l) m2row[tri_index(k, l)] = acc[3 * i + j];
    }
}

__global__ void __launch_bounds__(32 * MOM_WARPS)
moments_kernel(const uint32_t* __restrict__ bits, const float* __restrict__ color,
               const float* __restrict__ pixcov, const float* __restrict__ valid,
               int tp, int t, int h, int b, float* __restrict__ m2,
               float* __restrict__ misc) {
  extern __shared__ float4 win[];  // per window pixel: color, pixcov 0-3, 4-5
  const int nd = 2 * b + 1, n_off = nd * nd, nw = (n_off + 31) / 32;
  const int yr = blockIdx.x, n = blockIdx.y;
  const int W = t + 2 * b + 2, R = 2 * b + 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t slab = (size_t)n * tp * tp;
  const int py = h + yr;  // slab row of the centers
  const int wy0 = py - b - 1, wx0 = h - b - 1;

  for (int i = threadIdx.x; i < R * W; i += 32 * MOM_WARPS) {
    const size_t z = slab + (size_t)(wy0 + i / W) * tp + (wx0 + i % W);
    const float* c = color + z * 3;
    const float* v = pixcov + z * 6;
    win[3 * i] = make_float4(c[0], c[1], c[2], 0.f);
    win[3 * i + 1] = make_float4(v[0], v[1], v[2], v[3]);
    win[3 * i + 2] = make_float4(v[4], v[5], 0.f, 0.f);
  }
  __syncthreads();

  const bool two = lane >= NPX && lane < 22;
  const int2 blk = block_of(lane), blk2 = block_of(two ? lane + 23 : 0);
  const int qa = blk.x, qb = blk.y, qa2 = blk2.x, qb2 = blk2.y;
  const bool diag = lane < NPX;
  // window pixel of patch pixel q, relative to the candidate's top-left
  const int pa = (qa / 3) * W + qa % 3, pb = (qb / 3) * W + qb % 3;
  const int pa2 = (qa2 / 3) * W + qa2 % 3, pb2 = (qb2 / 3) * W + qb2 % 3;

  for (int x = warp; x < t; x += MOM_WARPS) {
    const size_t c = ((size_t)n * t + yr) * t + x;
    float acc[9] = {}, acc2[9] = {}, msum[3] = {}, nov[6] = {};
    int count = 0;
    for (int w = 0; w < nw; ++w) {
      uint32_t word = bits[c * nw + w];  // the same for the whole warp
      count += __popc(word);
      while (word) {
        const int o = w * 32 + __ffs(word) - 1;
        word &= word - 1;
        const int base = (o / nd) * W + x + o % nd;  // candidate's top-left
        const float4 ca = win[3 * (base + pa)];
        outer3(acc, ca, win[3 * (base + pb)]);
        if (two) outer3(acc2, win[3 * (base + pa2)], win[3 * (base + pb2)]);
        if (diag) {
          const float4 v0 = win[3 * (base + pa) + 1];
          const float4 v1 = win[3 * (base + pa) + 2];
          msum[0] += ca.x;
          msum[1] += ca.y;
          msum[2] += ca.z;
          nov[0] += v0.x;
          nov[1] += v0.y;
          nov[2] += v0.z;
          nov[3] += v0.w;
          nov[4] += v1.x;
          nov[5] += v1.y;
        }
      }
    }
    float* m2row = m2 + c * DTRI;
    store_block(m2row, acc, qa, qb);
    if (two) store_block(m2row, acc2, qa2, qb2);
    float* mrow = misc + c * MISC_CH;
    if (diag) {
#pragma unroll
      for (int i = 0; i < 3; ++i) mrow[3 * qa + i] = msum[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) mrow[D + 6 * qa + i] = nov[i];
    }
    if (lane == 0) {
      mrow[D + 6 * NPX] = (float)count;
      mrow[D + 6 * NPX + 1] =
          valid[(slab + (size_t)py * tp + h + x) * 2] > 0.f ? 1.f : 0.f;
    }
  }
}

// The band of one chi^2 block: the largest square band, t split evenly,
// whose staging fits MAX_SMEM (16 x 16 for 32 x 32 tiles at b = 6 and 60
// bins; 11 x 11, ragged, at b = 7); 0 when none fits.
int chi_band(int t, int b, int nbins) {
  for (int k = 1; k <= t; ++k) {
    const int side = (t + k - 1) / k;
    if (chi_geometry(b, nbins, side, side).bytes <= MAX_SMEM) return side;
  }
  return 0;
}

}  // namespace

extern "C" int bcd_masks_moments(const float* histo, const float* nb,
                                 const float* color, const float* pixcov,
                                 const float* valid, float thr, int n_tiles,
                                 int t, int h, int b, int nbins,
                                 uint32_t* bits, unsigned char* masks,
                                 float* m2, float* misc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tp = t + 2 * h;
  const int bh = chi_band(t, b, nbins), bw = bh;
  if (bh < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = chi_geometry(b, nbins, bh, bw).bytes;
  if (n_tiles > 0) {
    cudaFuncSetAttribute(chi2_masks_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int bands = ((t + bh - 1) / bh) * ((t + bw - 1) / bw);
    chi2_masks_kernel<<<dim3(bands, n_tiles), CHI_THREADS, smem, s>>>(
        histo, nb, valid, thr, tp, t, h, b, nbins, bh, bw, masks, bits);
    const size_t wsmem = (size_t)(2 * b + 3) * (t + 2 * b + 2) * 3 * 16;
    cudaFuncSetAttribute(moments_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
    moments_kernel<<<dim3(t, n_tiles), 32 * MOM_WARPS, wsmem, s>>>(
        bits, color, pixcov, valid, tp, t, h, b, m2, misc);
  }
  return (int)cudaGetLastError();
}
