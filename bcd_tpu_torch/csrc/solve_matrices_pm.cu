// K2 of the fused denoiser: the per-pixel two-step Bayesian solve.
//
// Replaces bcd_tpu/ops/solve_filter_pallas.py::solve_matrices_pm (TPU kernel
// body _solve_matrices_pm_kernel, math core _two_step_solve). Per pixel p:
//   m = msum / n, Cemp = (M2 - n m m^T) / (n - 1), BD = block-diagonal noise
//   from nov / n; a cyclic Jacobi eigendecomposition of Cemp - BD (fixed
//   round-robin schedule, `sweeps` sweeps) clamps its negative eigenvalues;
//   a Cholesky solve of (clamp + BD + eps I) X = BD gives A1^T = I - X;
//   cov2 = A1 Cemp A1^T; a second solve (cov2 + BD + eps I) X2 = BD gives
//   A2^T = I - X2 and b2 = X2^T m; gate = (n >= d + 1) & center_valid and
//   fb = center_valid & !gate.
//
// What bounds it on an H100: arithmetic and shared-memory traffic of the
// Jacobi clamp, 4 sweeps x 27 rounds x 14 rotations applied to a 28 x 28
// matrix and to its eigenvector matrix, about 1e6 flops per pixel, on
// matrices far too large for registers (729 floats each).
// The design: one warp per pixel; its three 28 x 29 matrices live in shared
// memory (10.5 KB a warp). The 14 disjoint rotations of a round are applied
// with one matrix column per lane, a row pass then a column pass, reading
// the round's pairs and angles from shared memory; the odd row stride of
// 29 puts the lanes of a column pass on distinct banks. The Cholesky
// factorization updates one trailing column per lane, and the triangular
// solves run one right-hand-side column per lane. Everything is fp32 with
// IEEE division and square root (no fast math).
//
// The clamp is formed as Cemp + sum over negative eigenvalues of
// (-lambda_k) v_k v_k^T, which equals V max(Lambda, 0) V^T + BD in exact
// arithmetic but carries no residual of the unconverged off-diagonal part.
//
// Channel maps (bcd_tpu_torch/ops/solve_filter.py): misc (P, 83) =
// [msum 27 | nov 54 | n | center_valid]; small (P, 56) =
// [b2 27 | gate | fb * m 27 | fb]; a2t (P, 729) with a2t[k * 27 + j] = A2[j][k].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 27;
constexpr int NPX = 9;
constexpr int DP = 28;                 // even size for the pairing schedule
constexpr int LD = 29;                 // shared row stride
constexpr int DTRI = D * (D + 1) / 2;  // packed upper triangle of M2
constexpr int MISC_CH = 83;
constexpr int SMALL_CH = 56;
constexpr int MAT = DP * LD;
constexpr int NPAIR = DP / 2;
constexpr int WARPS = 2;               // pixels per block
constexpr int PER_WARP = 3 * MAT + 32 + 64 + 32 + 32 + 32;

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

// round-robin pairing: player DP-1 is fixed, the others rotate; the DP-1
// rounds of a sweep visit every pair once
__device__ __forceinline__ void pair_of(int r, int i, int& p, int& q) {
  if (i == 0) {
    p = r;
    q = DP - 1;
  } else {
    p = (r + i) % (DP - 1);
    q = (r - i + (DP - 1)) % (DP - 1);
  }
}

// In-place Cholesky of the 27 x 27 matrix S (lower triangle; pivot guard
// max(pivot, 1e-30)), then X = S^-1 BD one column per lane.
__device__ void chol_solve_bd(float* S, float* X, const float* nov, int lane) {
  __syncwarp();
  for (int j = 0; j < D; ++j) {
    const float ljj = sqrtf(fmaxf(S[j * LD + j], 1e-30f));
    __syncwarp();
    const int k = lane;  // this lane's trailing column
    if (k > j && k < D) S[k * LD + j] = S[k * LD + j] / ljj;
    __syncwarp();
    if (lane == 0) S[j * LD + j] = ljj;
    if (k > j && k < D) {
      const float lkj = S[k * LD + j];
      for (int i = k; i < D; ++i) S[i * LD + k] -= S[i * LD + j] * lkj;
    }
    __syncwarp();
  }
  if (lane < D) {
    const int c = lane;
    const int i0 = 3 * (c / 3);  // BD's column c is zero above its block
    for (int i = 0; i < i0; ++i) X[i * LD + c] = 0.f;
    for (int i = i0; i < D; ++i) {
      float s = bd_at(nov, i, c);
      for (int k = i0; k < i; ++k) s -= S[i * LD + k] * X[k * LD + c];
      X[i * LD + c] = s / S[i * LD + i];
    }
    for (int i = D - 1; i >= 0; --i) {
      float s = X[i * LD + c];
      for (int k = i + 1; k < D; ++k) s -= S[k * LD + i] * X[k * LD + c];
      X[i * LD + c] = s / S[i * LD + i];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * WARPS)
solve_matrices_pm_kernel(const float* __restrict__ m2, const float* __restrict__ misc,
                      float eps, int n_pixels, int sweeps,
                      float* __restrict__ a2t, float* __restrict__ small) {
  __shared__ float smem[WARPS * PER_WARP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= n_pixels) return;
  float* C = smem + warp * PER_WARP;  // Cemp, then step 2's matrix
  float* A = C + MAT;                 // Jacobi matrix, step 1's, then H
  float* V = A + MAT;                 // eigenvectors, then solutions
  float* m = V + MAT;                 // masked mean patch
  float* nov = m + 32;                // mean noise blocks
  float* cs = nov + 64;               // rotation cosines [0, 14), sines [16, 30)
  float* lam = cs + 32;               // negative parts of the eigenvalues
  int* pq = (int*)(lam + 32);         // the round's pairs: p [0, 14), q [16, 30)

  const float* mp = misc + (size_t)p * MISC_CH;
  const float n = mp[D + 6 * NPX];
  const float cv = mp[D + 6 * NPX + 1];
  const float nsafe = fmaxf(n, 1.f);
  const float nm1 = fmaxf(n - 1.f, 1.f);
  if (lane < D) m[lane] = mp[lane] / nsafe;
  for (int i = lane; i < 6 * NPX; i += 32) nov[i] = mp[D + i] / nsafe;
  const float* tri = m2 + (size_t)p * DTRI;
  for (int k = 0, base = 0; k < D; base += D - k, ++k)
    for (int j = k + lane; j < D; j += 32) {
      const float v = tri[base + j - k];
      C[k * LD + j] = v;
      C[j * LD + k] = v;
    }
  __syncwarp();
  for (int idx = lane; idx < DP * DP; idx += 32) {
    const int i = idx / DP, j = idx % DP;
    float a = 0.f;
    if (i < D && j < D) {
      const float ce = (C[i * LD + j] - n * m[i] * m[j]) / nm1;
      C[i * LD + j] = ce;
      a = ce - bd_at(nov, i, j);
    }
    A[i * LD + j] = a;
    V[i * LD + j] = (i == j) ? 1.f : 0.f;
  }
  __syncwarp();

  // cyclic Jacobi on A = Cemp - BD (A <- J^T A J, V <- V J)
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < DP - 1; ++r) {
      if (lane < NPAIR) {
        int pp, qq;
        pair_of(r, lane, pp, qq);
        const float app = A[pp * LD + pp], aqq = A[qq * LD + qq], apq = A[pp * LD + qq];
        float c = 1.f, s = 0.f;
        if (fabsf(apq) >= 1e-30f) {
          const float tau = (aqq - app) / (2.f * apq);
          const float t = (tau == 0.f)
              ? 1.f : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
          c = 1.f / sqrtf(1.f + t * t);
          s = t * c;
        }
        cs[lane] = c;
        cs[16 + lane] = s;
        pq[lane] = pp;
        pq[16 + lane] = qq;
      }
      __syncwarp();
      if (lane < DP) {  // rows: lane = column j
        for (int i = 0; i < NPAIR; ++i) {
          const int pp = pq[i], qq = pq[16 + i];
          const float c = cs[i], s = cs[16 + i];
          const float ap = A[pp * LD + lane], aq = A[qq * LD + lane];
          A[pp * LD + lane] = c * ap - s * aq;
          A[qq * LD + lane] = s * ap + c * aq;
        }
      }
      __syncwarp();
      if (lane < DP) {  // columns: lane = row j
        for (int i = 0; i < NPAIR; ++i) {
          const int pp = pq[i], qq = pq[16 + i];
          const float c = cs[i], s = cs[16 + i];
          const float ap = A[lane * LD + pp], aq = A[lane * LD + qq];
          A[lane * LD + pp] = c * ap - s * aq;
          A[lane * LD + qq] = s * ap + c * aq;
          const float vp = V[lane * LD + pp], vq = V[lane * LD + qq];
          V[lane * LD + pp] = c * vp - s * vq;
          V[lane * LD + qq] = s * vp + c * vq;
        }
      }
      __syncwarp();
    }
  }

  // step 1: S1 = clamp(Cemp - BD) + BD + eps I
  if (lane < DP) lam[lane] = fmaxf(-A[lane * LD + lane], 0.f);
  __syncwarp();
  for (int idx = lane; idx < D * D; idx += 32) {
    const int i = idx / D, j = idx % D;
    float s = C[i * LD + j];
    for (int k = 0; k < D; ++k) {
      const float l = lam[k];
      if (l != 0.f) s += l * V[i * LD + k] * V[j * LD + k];
    }
    A[i * LD + j] = s + (i == j ? eps : 0.f);
  }
  chol_solve_bd(A, V, nov, lane);  // V = X, A1^T = I - X
  for (int idx = lane; idx < D * D; idx += 32) {
    const int i = idx / D, j = idx % D;
    V[i * LD + j] = (i == j ? 1.f : 0.f) - V[i * LD + j];
  }
  __syncwarp();

  // step 2: cov2 = A1 Cemp A1^T = (A1^T)^T H with H = Cemp A1^T; H goes
  // where step 1's factors were, cov2 + BD + eps I where Cemp was
  if (lane < D) {
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
      for (int k = 0; k < D; ++k) s += C[i * LD + k] * V[k * LD + lane];
      A[i * LD + lane] = s;
    }
  }
  __syncwarp();
  if (lane < D) {
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
      for (int k = 0; k < D; ++k) s += V[k * LD + i] * A[k * LD + lane];
      C[i * LD + lane] = s + bd_at(nov, i, lane) + (i == lane ? eps : 0.f);
    }
  }
  chol_solve_bd(C, V, nov, lane);  // V = X2 = T2^T

  float* out = a2t + (size_t)p * D * D;
  for (int idx = lane; idx < D * D; idx += 32) {
    const int k = idx / D, j = idx % D;
    out[idx] = (k == j ? 1.f : 0.f) - V[k * LD + j];
  }
  float* sm = small + (size_t)p * SMALL_CH;
  const float gate = (n >= (float)(D + 1) && cv > 0.f) ? 1.f : 0.f;
  const float fb = cv * (1.f - gate);
  if (lane < D) {
    float b2 = 0.f;
    for (int k = 0; k < D; ++k) b2 += V[k * LD + lane] * m[k];
    sm[lane] = b2;
    sm[D + 1 + lane] = fb * m[lane];
  }
  if (lane == 0) {
    sm[D] = gate;
    sm[2 * D + 1] = fb;
  }
}

}  // namespace

extern "C" int bcd_solve_matrices_pm(const float* m2, const float* misc,
                                     float eps, int n_pixels, int sweeps,
                                     float* a2t, float* small, void* stream) {
  if (n_pixels > 0) {
    const int blocks = (n_pixels + WARPS - 1) / WARPS;
    solve_matrices_pm_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        m2, misc, eps, n_pixels, sweeps, a2t, small);
  }
  return (int)cudaGetLastError();
}
