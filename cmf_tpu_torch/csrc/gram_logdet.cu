// Fused Gram + Cholesky + log-det for the exact non-square log-det, forward
// and backward, written for Hopper (sm_90a).
//
// Replaces the two Pallas/TPU kernels of cmf_tpu/ops/pallas/gram_logdet.py:
//   gram_logdet_fwd_kernel  <- _fwd_kernel (gram_logdet.py:75), via _fwd_call
//   gram_logdet_bwd_kernel  <- _bwd_kernel (gram_logdet.py:109), via _bwd_call
//
// Per batch element b, from the (d, B, D) Jacobian columns J[i, b, :]:
//   forward:  G = JᵀJ (d×d), its Cholesky-Banachiewicz factor L and
//             log|G| = Σ_j log s_j, s_j the pivots (= 2 Σ log diag L).
//             A non-PD Gram gives a NaN / -inf log-det, never a clamp, so the
//             caller's jitter-retry fallback still triggers.
//   backward: dJ[i] = Σ_j (Ḡ[i,j] + Ḡ[j,i] + 2·ḡ_ld·G⁻¹[i,j]) · J[j],
//             with G⁻¹ = XᵀX rebuilt from the saved L by forward
//             substitution (X = L⁻¹). Where ḡ_ld is 0 the G⁻¹ term is skipped:
//             it contributes nothing, and a NaN factor (the fallback case)
//             must not turn the Ḡ-only gradient into NaN.
//
// Design. The TPU kernel puts 128 batch elements on the VPU lanes and unrolls
// ~d³/6 vector ops at trace time. Here one thread block owns one batch
// element (B = 400 blocks over 132 SMs at the main-path shape): its J slice
// (d×D ≤ 32×128 fp32 = 16 KB) is staged in shared memory, the d(d+1)/2 Gram
// dot products are shared out over 128 threads, and the factorisation runs
// column by column with two barriers per column. Everything is fp32 with the
// sums in a fixed order, like the fp32-HIGHEST reference.
//
// Bound on an H100 SXM at the main path (d=21, B=400, D=43): memory. The
// forward reads J (1.44 MB) and writes G and L (1.41 MB), ~0.9 µs at
// 3.35 TB/s; the backward moves ~4.3 MB, ~1.3 µs. The arithmetic (a few
// MFLOP) is far below the fp32 peak. At these sizes launch latency and the
// serial column loop dominate; this first version aims to be right.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxD = 32;      // latent-dimension gate (gram_logdet.py:44)
constexpr int kMaxAmb = 128;   // ambient-dimension gate (gram_logdet.py:45)
constexpr int kThreads = 128;
constexpr int kPad = kMaxD + 1;  // row stride of the d×d tiles in shared memory

__global__ void __launch_bounds__(kThreads)
gram_logdet_fwd_kernel(const float* __restrict__ jac, float* __restrict__ gram,
                       float* __restrict__ logdet, float* __restrict__ chol,
                       int d, int B, int D) {
  __shared__ float J[kMaxD * kMaxAmb];
  __shared__ float G[kMaxD * kPad];
  __shared__ float L[kMaxD * kPad];
  __shared__ float piv[kMaxD];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // 1. Stage this element's columns: J[i, :] = jac[i, b, :].
  for (int q = tid; q < d * D; q += blockDim.x) {
    const int i = q / D, k = q - i * D;
    J[i * D + k] = jac[((size_t)i * B + b) * D + k];
  }
  __syncthreads();

  // 2. Gram, lower triangle, mirrored.
  for (int q = tid; q < d * d; q += blockDim.x) {
    const int i = q / d, j = q - i * d;
    if (j > i) continue;
    const float* ri = J + i * D;
    const float* rj = J + j * D;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc = fmaf(ri[k], rj[k], acc);
    G[i * kPad + j] = acc;
    G[j * kPad + i] = acc;
  }
  __syncthreads();

  // 3. Cholesky-Banachiewicz, column j at a time. Thread t owns row j + t
  //    (d ≤ 32 < blockDim, so one pass covers the column). Row j's thread
  //    forms the pivot s_j; after the barrier every row divides by sqrt(s_j).
  float ld = 0.f;
  for (int j = 0; j < d; ++j) {
    const int i = j + tid;
    float t = 0.f;
    if (i < d) {
      t = G[i * kPad + j];
      for (int k = 0; k < j; ++k) t -= L[i * kPad + k] * L[j * kPad + k];
      if (i == j) piv[j] = t;
    }
    __syncthreads();
    const float s = piv[j];
    if (i < d) {
      const float r = sqrtf(s);
      L[i * kPad + j] = (i == j) ? r : t / r;
    }
    if (tid == 0) ld += logf(s);
    __syncthreads();
  }

  // 4. Write G (full, symmetric), L (upper triangle zero) and the log-det.
  float* gb = gram + (size_t)b * d * d;
  float* lb = chol + (size_t)b * d * d;
  for (int q = tid; q < d * d; q += blockDim.x) {
    const int i = q / d, j = q - i * d;
    gb[q] = G[i * kPad + j];
    lb[q] = (j <= i) ? L[i * kPad + j] : 0.f;
  }
  if (tid == 0) logdet[b] = ld;
}

__global__ void __launch_bounds__(kThreads)
gram_logdet_bwd_kernel(const float* __restrict__ jac, const float* __restrict__ chol,
                       const float* __restrict__ gbar, const float* __restrict__ ldbar,
                       float* __restrict__ djac, int d, int B, int D) {
  __shared__ float J[kMaxD * kMaxAmb];
  __shared__ float L[kMaxD * kPad];
  __shared__ float X[kMaxD * kPad];
  __shared__ float M[kMaxD * kPad];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float g_ld = ldbar[b];
  const float* lb = chol + (size_t)b * d * d;
  const float* gbb = gbar + (size_t)b * d * d;

  // 1. Load J, L and M = Ḡ + Ḡᵀ.
  for (int q = tid; q < d * D; q += blockDim.x) {
    const int i = q / D, k = q - i * D;
    J[i * D + k] = jac[((size_t)i * B + b) * D + k];
  }
  for (int q = tid; q < d * d; q += blockDim.x) {
    const int i = q / d, j = q - i * d;
    L[i * kPad + j] = lb[q];
    M[i * kPad + j] = gbb[q] + gbb[j * d + i];
  }
  __syncthreads();

  if (g_ld != 0.f) {  // the same for every thread of the block
    // 2. X = L⁻¹ by forward substitution: rows in turn, columns in parallel.
    //    X[i][j] = -(Σ_{k=j}^{i-1} L[i][k]·X[k][j]) / L[i][i], X[i][i] = 1/L[i][i].
    for (int i = 0; i < d; ++i) {
      if (tid <= i) {
        const int j = tid;
        float t = 1.f;
        if (j < i) {
          t = 0.f;
          for (int k = j; k < i; ++k) t -= L[i * kPad + k] * X[k * kPad + j];
        }
        X[i * kPad + j] = t * (1.f / L[i * kPad + i]);
      }
      __syncthreads();
    }
    // 3. M += 2·ḡ_ld·G⁻¹, G⁻¹[i][j] = Σ_{k ≥ max(i,j)} X[k][i]·X[k][j].
    //    (The upper triangle of X is never written and never read.)
    const float two_g = 2.f * g_ld;
    for (int q = tid; q < d * d; q += blockDim.x) {
      const int i = q / d, j = q - i * d;
      float acc = 0.f;
      for (int k = (i > j ? i : j); k < d; ++k) acc += X[k * kPad + i] * X[k * kPad + j];
      M[i * kPad + j] += two_g * acc;
    }
    __syncthreads();
  }

  // 4. dJ[i, b, :] = Σ_j M[i][j]·J[j, :], parallel over (i, D).
  for (int q = tid; q < d * D; q += blockDim.x) {
    const int i = q / D, k = q - i * D;
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(M[i * kPad + j], J[j * D + k], acc);
    djac[((size_t)i * B + b) * D + k] = acc;
  }
}

bool shape_ok(int d, int B, int D) {
  return d >= 1 && d <= kMaxD && D >= 1 && D <= kMaxAmb && B >= 1;
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// fp32 tensors: jac (d, B, D); gram, chol, gbar (B, d, d); logdet, ldbar (B,);
// djac (d, B, D). The kernel runs on `stream`; the return value is
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cmf_gram_logdet_fwd(const void* jac, void* gram, void* logdet, void* chol,
                                   int d, int B, int D, void* stream) {
  if (!shape_ok(d, B, D)) return (int)cudaErrorInvalidValue;
  gram_logdet_fwd_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)jac, (float*)gram, (float*)logdet, (float*)chol, d, B, D);
  return (int)cudaGetLastError();
}

extern "C" int cmf_gram_logdet_bwd(const void* jac, const void* chol, const void* gbar,
                                   const void* ldbar, void* djac, int d, int B, int D,
                                   void* stream) {
  if (!shape_ok(d, B, D)) return (int)cudaErrorInvalidValue;
  gram_logdet_bwd_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)jac, (const float*)chol, (const float*)gbar, (const float*)ldbar,
      (float*)djac, d, B, D);
  return (int)cudaGetLastError();
}
