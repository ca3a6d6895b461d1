// solve_filter and the lane-form solve_matrices: the per-pixel two-step
// Bayesian solve at the patch sizes the engine runs (d = 27 and d = 75).
//
// Replaces bcd_tpu/ops/solve_filter_pallas.py::solve_filter (TPU kernel
// body _solve_filter_kernel) and ::solve_matrices (body
// _solve_matrices_kernel, math core _two_step_solve). Per pixel p:
//   solve_filter:   M2 = sum_o mask_o c_o c_o^T over the candidate stack;
//                   the mean patch m, the set size n and the mean noise
//                   blocks are given.
//   solve_matrices: M2, the patch sums and the noise sums are given;
//                   m = msum / max(n, 1), noise = nov / max(n, 1).
//   Both: Cemp = (M2 - n m m^T) / max(n - 1, 1), BD = block-diagonal noise;
//   a cyclic Jacobi eigendecomposition of Cemp - BD (fixed round-robin
//   schedule, `sweeps` sweeps) clamps its negative eigenvalues; a Cholesky
//   solve of (clamp + BD + eps I) X = BD gives A1^T = I - X;
//   cov2 = A1 Cemp A1^T; a second solve (cov2 + BD + eps I) X2 = BD gives
//   T2^T = X2, so A2^T = I - X2 and b2 = X2^T m.
//   solve_filter writes field_o = mask_o (c_o - T2 c_o + b2) for every
//   candidate o; solve_matrices writes (A2^T, b2).
//
// What bounds it on an H100: the Jacobi clamp. At d = 75 (patch radius 2) a
// sweep is 75 rounds of 38 rotations, each applied to two rows and two
// columns of a 76 x 76 matrix and to two columns of its eigenvector matrix:
// about 23 of the ~28 MFLOP a pixel costs at 6 sweeps. The three 76 x 77
// fp32 matrices of a pixel (70 KB) are far too large for registers, so every
// operand of a rotation is a shared-memory load and store: the kernel is
// bound by shared-memory traffic and by the block-wide barriers between
// rounds, not by the FMA rate.
// The design: one block of 256 threads per pixel (128 at d = 27) with its
// matrices in dynamic shared memory (three blocks an SM at d = 75). A round
// is three passes: 38 threads form the round's rotations (cosine, sine and
// pair in one float4 that the other passes read as a broadcast), then a row
// pass and a column pass over (pair, column) items spread over the whole
// block; the odd row stride of 77 puts the column pass's threads on
// distinct banks. The clamp is formed as Cemp + sum over negative
// eigenvalues of (-lambda_k) v_k v_k^T, which equals V max(Lambda, 0) V^T
// + BD in exact arithmetic but carries no residue of the unconverged
// off-diagonal part. Cholesky and the triangular solves are right-looking,
// each step's update spread over the block. Candidates are staged through
// shared memory in chunks for the second moment and for the filter.
// Everything is fp32 with IEEE division and square root (no fast math).
//
// Layouts (pixel-major, P pixels; bcd_tpu_torch/ops/solve_filter.py
// transposes JAX's lane-major arrays to these):
//   solve_filter:   cand (P, O, d), mask (P, O), noise (P, 6 npx) with the
//                   channels xx yy zz yz xz xy per patch pixel, n (P),
//                   m (P, d) -> field (P, O, d);
//   solve_matrices: m2 (P, d, d), msum (P, d), nov (P, 6 npx), n (P)
//                   -> a2t (P, d, d) with a2t[k][j] = A2[j][k], b2 (P, d).

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int D>
struct Geo {
  static constexpr int NPX = D / 3;
  static constexpr int NOV = 6 * NPX;
  static constexpr int DP = D + (D & 1);  // even size for the pairing
  static constexpr int LD = DP + 1;       // odd shared row stride
  static constexpr int MAT = DP * LD;
  static constexpr int NPAIR = DP / 2;
  static constexpr int THREADS = D > 32 ? 256 : 128;
  static constexpr int MIN_BLOCKS = D > 32 ? 3 : 8;
  static constexpr int CHUNK = MAT / D;  // candidates staged at once
  // shared layout in floats: rotations (float4 each), C, A, V, m, noise,
  // lambda (then b2)
  static constexpr int C_OFF = 4 * NPAIR;
  static constexpr int A_OFF = C_OFF + MAT;
  static constexpr int V_OFF = A_OFF + MAT;
  static constexpr int M_OFF = V_OFF + MAT;
  static constexpr int NOV_OFF = M_OFF + DP;
  static constexpr int LAM_OFF = NOV_OFF + NOV;
  static constexpr int FLOATS = LAM_OFF + DP;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
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

// round-robin pairing: player DP-1 is fixed, the others rotate; the DP-1
// rounds of a sweep visit every pair once
template <int DP>
__device__ __forceinline__ void pair_of(int r, int i, int& p, int& q) {
  if (i == 0) {
    p = r;
    q = DP - 1;
  } else {
    p = (r + i) % (DP - 1);
    q = (r - i + (DP - 1)) % (DP - 1);
  }
}

// In-place Cholesky S = L L^T (lower triangle read and written; pivot guard
// max(pivot, 1e-30)), then X = S^-1 BD by forward and back substitution.
// Starts and ends with a barrier.
template <int D>
__device__ void chol_solve_bd(float* S, float* X, const float* nov) {
  using G = Geo<D>;
  constexpr int LD = G::LD, T = G::THREADS;
  const int tid = threadIdx.x;
  for (int j = 0; j < D; ++j) {
    __syncthreads();
    const float ljj = sqrtf(fmaxf(S[j * LD + j], 1e-30f));
    for (int k = j + 1 + tid; k < D; k += T) S[k * LD + j] = S[k * LD + j] / ljj;
    __syncthreads();
    if (tid == 0) S[j * LD + j] = ljj;
    const int m = D - 1 - j;
    for (int idx = tid; idx < m * m; idx += T) {
      const int ii = idx / m, kk = idx - ii * m;
      if (kk <= ii) {
        const int i = j + 1 + ii, k = j + 1 + kk;
        S[i * LD + k] -= S[i * LD + j] * S[k * LD + j];
      }
    }
  }
  for (int idx = tid; idx < D * D; idx += T) {
    const int i = idx / D, c = idx - i * D;
    X[i * LD + c] = bd_at(nov, i, c);
  }
  // L Y = BD, one row of Y at a time, its update of the rows below spread
  // over the block
  for (int k = 0; k < D; ++k) {
    __syncthreads();
    const float lkk = S[k * LD + k];
    for (int c = tid; c < D; c += T) X[k * LD + c] = X[k * LD + c] / lkk;
    __syncthreads();
    for (int idx = tid; idx < (D - 1 - k) * D; idx += T) {
      const int i = k + 1 + idx / D, c = idx % D;
      X[i * LD + c] -= S[i * LD + k] * X[k * LD + c];
    }
  }
  // L^T X = Y, from the last row up
  for (int k = D - 1; k >= 0; --k) {
    __syncthreads();
    const float lkk = S[k * LD + k];
    for (int c = tid; c < D; c += T) X[k * LD + c] = X[k * LD + c] / lkk;
    __syncthreads();
    for (int idx = tid; idx < k * D; idx += T) {
      const int i = idx / D, c = idx % D;
      X[i * LD + c] -= S[k * LD + i] * X[k * LD + c];
    }
  }
  __syncthreads();
}

// The two-step solve from Cemp (in C, both triangles), the mean patch m and
// the mean noise channels; leaves X2 = T2^T in V and b2 in the lambda slot.
template <int D>
__device__ void two_step(float* sm, float eps, int sweeps) {
  using G = Geo<D>;
  constexpr int DP = G::DP, LD = G::LD, T = G::THREADS, NPAIR = G::NPAIR;
  float* C = sm + G::C_OFF;
  float* A = sm + G::A_OFF;
  float* V = sm + G::V_OFF;
  const float* m = sm + G::M_OFF;
  const float* nov = sm + G::NOV_OFF;
  float* lam = sm + G::LAM_OFF;
  float4* rot = reinterpret_cast<float4*>(sm);
  const int tid = threadIdx.x;

  __syncthreads();
  for (int idx = tid; idx < DP * DP; idx += T) {
    const int i = idx / DP, j = idx - i * DP;
    A[i * LD + j] = (i < D && j < D) ? C[i * LD + j] - bd_at(nov, i, j) : 0.f;
    V[i * LD + j] = (i == j) ? 1.f : 0.f;
  }

  // cyclic Jacobi on A = Cemp - BD (A <- J^T A J, V <- V J)
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < DP - 1; ++r) {
      __syncthreads();
      if (tid < NPAIR) {
        int p, q;
        pair_of<DP>(r, tid, p, q);
        const float app = A[p * LD + p], aqq = A[q * LD + q], apq = A[p * LD + q];
        float c = 1.f, s = 0.f;
        if (fabsf(apq) >= 1e-30f) {
          const float tau = (aqq - app) / (2.f * apq);
          const float t = (tau == 0.f)
              ? 1.f : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
          c = 1.f / sqrtf(1.f + t * t);
          s = t * c;
        }
        rot[tid] = make_float4(c, s, __int_as_float(p), __int_as_float(q));
      }
      __syncthreads();
      for (int idx = tid; idx < NPAIR * DP; idx += T) {  // rows p, q; column j
        const int i = idx / DP, j = idx - i * DP;
        const float4 g = rot[i];
        const int po = __float_as_int(g.z) * LD + j, qo = __float_as_int(g.w) * LD + j;
        const float ap = A[po], aq = A[qo];
        A[po] = g.x * ap - g.y * aq;
        A[qo] = g.y * ap + g.x * aq;
      }
      __syncthreads();
      for (int idx = tid; idx < NPAIR * DP; idx += T) {  // columns p, q; row j
        const int i = idx / DP, j = idx - i * DP;
        const float4 g = rot[i];
        const int po = j * LD + __float_as_int(g.z), qo = j * LD + __float_as_int(g.w);
        const float ap = A[po], aq = A[qo];
        A[po] = g.x * ap - g.y * aq;
        A[qo] = g.y * ap + g.x * aq;
        const float vp = V[po], vq = V[qo];
        V[po] = g.x * vp - g.y * vq;
        V[qo] = g.y * vp + g.x * vq;
      }
    }
  }
  __syncthreads();

  // step 1: S1 = clamp(Cemp - BD) + BD + eps I = Cemp + sum_{lambda < 0}
  // (-lambda) v v^T + eps I, lower triangle (all Cholesky reads)
  for (int k = tid; k < DP; k += T) lam[k] = fmaxf(-A[k * LD + k], 0.f);
  __syncthreads();
  for (int idx = tid; idx < D * D; idx += T) {
    const int i = idx / D, j = idx - i * D;
    if (j > i) continue;
    float s = C[i * LD + j];
    for (int k = 0; k < D; ++k) {
      const float l = lam[k];
      if (l != 0.f) s += l * V[i * LD + k] * V[j * LD + k];
    }
    A[i * LD + j] = s + (i == j ? eps : 0.f);
  }
  chol_solve_bd<D>(A, V, nov);  // V = X, A1^T = I - X
  for (int idx = tid; idx < D * D; idx += T) {
    const int i = idx / D, j = idx - i * D;
    V[i * LD + j] = (i == j ? 1.f : 0.f) - V[i * LD + j];
  }
  __syncthreads();

  // step 2: cov2 = A1 Cemp A1^T = (A1^T)^T H with H = Cemp A1^T; H goes
  // where step 1's factor was, cov2 + BD + eps I (lower) where Cemp was
  for (int idx = tid; idx < D * D; idx += T) {
    const int i = idx / D, j = idx - i * D;
    float s = 0.f;
    for (int k = 0; k < D; ++k) s += C[i * LD + k] * V[k * LD + j];
    A[i * LD + j] = s;
  }
  __syncthreads();
  for (int idx = tid; idx < D * D; idx += T) {
    const int i = idx / D, j = idx - i * D;
    if (j > i) continue;
    float s = 0.f;
    for (int k = 0; k < D; ++k) s += V[k * LD + i] * A[k * LD + j];
    C[i * LD + j] = s + bd_at(nov, i, j) + (i == j ? eps : 0.f);
  }
  chol_solve_bd<D>(C, V, nov);  // V = X2 = T2^T

  // b2 = T2 m: b2[j] = sum_k X2[k][j] m[k]
  for (int j = tid; j < D; j += T) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) s += V[k * LD + j] * m[k];
    lam[j] = s;
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(Geo<D>::THREADS, Geo<D>::MIN_BLOCKS)
solve_filter_kernel(const float* __restrict__ cand, const float* __restrict__ mask,
                    const float* __restrict__ noise, const float* __restrict__ n_in,
                    const float* __restrict__ m_in, float eps, int n_off, int sweeps,
                    float* __restrict__ field) {
  using G = Geo<D>;
  constexpr int LD = G::LD, T = G::THREADS, EPT = (D * D + T - 1) / T;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* C = sm + G::C_OFF;
  float* A = sm + G::A_OFF;
  float* V = sm + G::V_OFF;
  float* m = sm + G::M_OFF;
  float* nov = sm + G::NOV_OFF;
  const float* b2 = sm + G::LAM_OFF;
  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  const float* cp = cand + p * n_off * D;
  const float* wp = mask + p * n_off;
  float* fp = field + p * n_off * D;
  const float n = n_in[p];
  for (int i = tid; i < D; i += T) m[i] = m_in[p * D + i];
  for (int i = tid; i < G::NOV; i += T) nov[i] = noise[p * G::NOV + i];

  // M2 = sum_o w_o c_o c_o^T over chunks of candidates staged in shared
  // memory (A: w_o c_o, V: c_o); each thread sums its upper-triangle entries
  float acc[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) acc[u] = 0.f;
  for (int o0 = 0; o0 < n_off; o0 += G::CHUNK) {
    const int cnt = min(G::CHUNK, n_off - o0);
    __syncthreads();
    for (int idx = tid; idx < cnt * D; idx += T) {
      const float c = cp[(size_t)o0 * D + idx];
      A[idx] = wp[o0 + idx / D] * c;
      V[idx] = c;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = tid + u * T;
      const int k = e / D, l = e - k * D;
      if (e < D * D && k <= l) {
        float s = 0.f;
        for (int o = 0; o < cnt; ++o) s += A[o * D + k] * V[o * D + l];
        acc[u] += s;
      }
    }
  }
  __syncthreads();
  const float nm1 = fmaxf(n - 1.f, 1.f);
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int e = tid + u * T;
    const int k = e / D, l = e - k * D;
    if (e < D * D && k <= l) {
      const float ce = (acc[u] - n * m[k] * m[l]) / nm1;
      C[k * LD + l] = ce;
      C[l * LD + k] = ce;
    }
  }

  two_step<D>(sm, eps, sweeps);

  // field_o = mask_o (c_o - T2 c_o + b2), candidates staged again in A
  for (int o0 = 0; o0 < n_off; o0 += G::CHUNK) {
    const int cnt = min(G::CHUNK, n_off - o0);
    __syncthreads();
    for (int idx = tid; idx < cnt * D; idx += T) A[idx] = cp[(size_t)o0 * D + idx];
    __syncthreads();
    for (int idx = tid; idx < cnt * D; idx += T) {
      const int o = idx / D, i = idx - o * D;
      const float w = wp[o0 + o];
      float out = 0.f;
      if (w != 0.f) {
        float s = 0.f;
        for (int k = 0; k < D; ++k) s += A[o * D + k] * V[k * LD + i];
        out = (A[o * D + i] - s + b2[i]) * w;
      }
      fp[(size_t)o0 * D + idx] = out;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Geo<D>::THREADS, Geo<D>::MIN_BLOCKS)
solve_matrices_kernel(const float* __restrict__ m2, const float* __restrict__ msum,
                      const float* __restrict__ nov_in, const float* __restrict__ n_in,
                      float eps, int sweeps, float* __restrict__ a2t,
                      float* __restrict__ b2) {
  using G = Geo<D>;
  constexpr int LD = G::LD, T = G::THREADS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* C = sm + G::C_OFF;
  const float* V = sm + G::V_OFF;
  float* m = sm + G::M_OFF;
  float* nov = sm + G::NOV_OFF;
  const float* b2s = sm + G::LAM_OFF;
  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  const float n = n_in[p];
  const float inv_n = 1.f / fmaxf(n, 1.f);
  const float nm1 = fmaxf(n - 1.f, 1.f);
  for (int i = tid; i < D; i += T) m[i] = msum[p * D + i] * inv_n;
  for (int i = tid; i < G::NOV; i += T) nov[i] = nov_in[p * G::NOV + i] * inv_n;
  __syncthreads();
  const float* mp = m2 + p * D * D;
  for (int idx = tid; idx < D * D; idx += T) {
    const int k = idx / D, l = idx - k * D;
    C[k * LD + l] = (mp[idx] - n * m[k] * m[l]) / nm1;
  }

  two_step<D>(sm, eps, sweeps);

  float* ap = a2t + p * D * D;
  for (int idx = tid; idx < D * D; idx += T) {
    const int k = idx / D, j = idx - k * D;
    ap[idx] = (k == j ? 1.f : 0.f) - V[k * LD + j];
  }
  for (int j = tid; j < D; j += T) b2[p * D + j] = b2s[j];
}

template <int D>
int launch_filter(const float* cand, const float* mask, const float* noise,
                  const float* n, const float* m, float eps, int n_pixels,
                  int n_off, int sweeps, float* field, cudaStream_t stream) {
  using G = Geo<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_filter_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  solve_filter_kernel<D><<<n_pixels, G::THREADS, G::BYTES, stream>>>(
      cand, mask, noise, n, m, eps, n_off, sweeps, field);
  return (int)cudaGetLastError();
}

template <int D>
int launch_matrices(const float* m2, const float* msum, const float* nov,
                    const float* n, float eps, int n_pixels, int sweeps,
                    float* a2t, float* b2, cudaStream_t stream) {
  using G = Geo<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      solve_matrices_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  solve_matrices_kernel<D><<<n_pixels, G::THREADS, G::BYTES, stream>>>(
      m2, msum, nov, n, eps, sweeps, a2t, b2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bcd_solve_filter(const float* cand, const float* mask,
                                const float* noise, const float* n,
                                const float* m, float eps, int n_pixels,
                                int n_off, int d, int sweeps, float* field,
                                void* stream) {
  if (n_pixels <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 27)
    return launch_filter<27>(cand, mask, noise, n, m, eps, n_pixels, n_off, sweeps, field, s);
  if (d == 75)
    return launch_filter<75>(cand, mask, noise, n, m, eps, n_pixels, n_off, sweeps, field, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bcd_solve_matrices(const float* m2, const float* msum,
                                  const float* nov, const float* n, float eps,
                                  int n_pixels, int d, int sweeps, float* a2t,
                                  float* b2, void* stream) {
  if (n_pixels <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 27)
    return launch_matrices<27>(m2, msum, nov, n, eps, n_pixels, sweeps, a2t, b2, s);
  if (d == 75)
    return launch_matrices<75>(m2, msum, nov, n, eps, n_pixels, sweeps, a2t, b2, s);
  return (int)cudaErrorInvalidValue;
}
