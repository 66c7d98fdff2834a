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
//             computed as M·J + 2·ḡ_ld·Z with M = Ḡ + Ḡᵀ and Z = G⁻¹J
//             = L⁻ᵀ(L⁻¹J) by two triangular solves on the saved L, without
//             forming G⁻¹. Where ḡ_ld is 0 the solves are skipped: the term
//             contributes nothing, and a NaN factor (the fallback case) must
//             not turn the Ḡ-only gradient into NaN.
//
// Forward design. The TPU kernel puts 128 batch elements on the VPU lanes and
// unrolls ~d³/6 vector ops at trace time. Here one warp owns one batch
// element, four warps a block, and the only synchronisation is __syncwarp().
// The warp's tiles live in dynamic shared memory, zero-padded to dp = d
// rounded up to 4: J k-major (J[k·S + i] = jac[i, b, k], so one 16-byte load
// holds four rows at one k) and A, which holds G and then L in place,
// row-major, with 1 on the pad diagonal, so the pad pivots are 1, add
// log 1 = 0 to the log-det, and no loop has a remainder; 7.3 KB a warp at the
// main path, 22.5 KB at the gate's edge (d=32, D=128), so a block opts in
// above 48 KB. One round of cp.async brings J in. Then:
//   1. the Gram in 4×4 register blocks: lane q owns the q-th block of the
//      lower block triangle (21 blocks at d=21; 36 at d=32, so four lanes
//      take a second one) and sums its 16 entries over k in order, fp32
//      fmaf, from two 16-byte loads a k; the block and its transpose go into
//      A, and G is stored from A, d·d contiguous floats;
//   2. Cholesky-Banachiewicz in 4-column panels, lane i owning row i: each
//      row forms its four panel entries less what the columns left of the
//      panel contribute (four independent chains), every lane factors the
//      panel's 4×4 diagonal triangle in registers from shuffles, and each
//      row below solves its four entries against it; one __syncwarp a panel
//      (d/4 of them, where a block an element would need two barriers a
//      column).
// The root is rsqrtf, as the TPU kernel's rsqrt: q = rsqrtf(s), L[j][j] = s·q,
// L[i][j] = t·q, and the log-det adds logf(s). A pivot s ≤ 0 gives NaN or
// -inf, never a clamp. Bound on an H100 SXM at the main path (d=21, B=400,
// D=43): memory. It reads J (1.44 MB) and writes G, L and the log-det
// (1.41 MB): 0.853 µs at 3.35 TB/s; the arithmetic (~0.01 MFLOP an element)
// is far below the fp32 peak. Why a warp's latency keeps it above that
// bound: 400 warps are fewer than the card's 528 schedulers, so nothing hides
// one warp's chain (the load round trip, D dependent steps of the Gram sums,
// d/4 panels each waiting on the one before, then the stores), and the time
// is about the same at B=100 as at B=400 (chip_smoke.py times both).
//
// Backward design (the TPU kernel rebuilt G⁻¹ = L⁻ᵀL⁻¹ by unrolled vector ops
// over 128 lane-resident batch elements, then one d×d by d×D product). Here
// one warp owns one batch element, four warps a block, and the only
// synchronisation is one __syncwarp() after the loads. Lane k owns the
// columns k, k+32, …: each column's two solves and its M·J sums are private
// to one lane, L and M are shared-memory broadcasts, and every global load
// and store of a J row is contiguous. The warp's tiles live in dynamic
// shared memory, zero-padded to dp = d rounded up to 4 rows: J and a work
// tile W column-major (a lane's column is contiguous), T (L below the
// diagonal, Lᵀ above it, 1/L[i][i] on it), M = Ḡ + Ḡᵀ and Ḡᵀ; 17.7 KB a warp
// at the main path, 50.7 KB at the gate's edge (d=32, D=128), so a block
// opts in above 48 KB. cp.async brings everything in at once, the
// transposes and the zero pads included. Then, four rows at a time, with
// 16-byte shared loads that serve four rows of a column:
//   1. Y = L⁻¹J into W (forward substitution): what the rows above the
//      group contribute, then the 4×4 triangle in registers;
//   2. from the bottom, Z = L⁻ᵀY in place on W (back substitution) in the
//      same loops as the group's M·J sums, then dJ = M·J + 2·ḡ_ld·Z.
// Why the bytes bound (1.3 µs) is out of reach: 400 warps are fewer than
// the card's 528 schedulers, so nothing hides a warp's latency. A column's
// solves are a chain of dependent steps (each group waits for the one
// before), and every step waits on shared-memory loads, so the time is a
// warp's latency and about the same at B=100 as at B=400 (chip_smoke.py
// times both).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kMaxD = 32;      // latent-dimension gate (gram_logdet.py:44)
constexpr int kMaxAmb = 128;   // ambient-dimension gate (gram_logdet.py:45)
// Launch geometry of both kernels: kWarps warps a block, one batch element a
// warp, each warp's tiles in dynamic shared memory (above 48 KB a block after
// the opt-in attribute). The backward timed the same with 1, 2 and 4 warps a
// block on an H100: a warp's latency sets the time (PERF.md).
constexpr int kWarps = 4;
constexpr unsigned kFullMask = 0xffffffffu;
// Rows a lane carries at once: the backward's row groups, the forward's
// Gram blocks and Cholesky panels.
constexpr int R = 4;

// The tiles' padded row count dp = d rounded up to R, and their stride S:
// dp, or dp + 4 where dp/4 is even, so that S/4 is odd and a 16-byte load by
// each lane of a quarter-warp, lanes S floats apart, meets 8 distinct bank
// groups.
__host__ __device__ constexpr int tile_rows(int d) { return (d + R - 1) / R * R; }
__host__ __device__ constexpr int tile_stride(int d) {
  return (tile_rows(d) / 4) % 2 ? tile_rows(d) : tile_rows(d) + 4;
}
// Floats of one warp's tiles. Forward: J (D rows of dp) and A (dp rows).
// Backward: J and W (D columns of dp), T, M and Ḡᵀ (dp rows).
__host__ __device__ constexpr int fwd_tile_floats(int d, int D) {
  return (D + tile_rows(d)) * tile_stride(d);
}
__host__ __device__ constexpr int bwd_tile_floats(int d, int D) {
  return (2 * D + 3 * tile_rows(d)) * tile_stride(d);
}
// Dynamic shared bytes of a block at (d, D).
constexpr int fwd_smem_bytes(int d, int D) {
  return kWarps * fwd_tile_floats(d, D) * (int)sizeof(float);
}
constexpr int bwd_smem_bytes(int d, int D) {
  return kWarps * bwd_tile_floats(d, D) * (int)sizeof(float);
}
static_assert(fwd_smem_bytes(kMaxD, kMaxAmb) <= 232448 && bwd_smem_bytes(kMaxD, kMaxAmb) <= 232448,
              "the gate's largest block must fit the 227 KB a block can have");

// A 4-byte copy from global memory to the shared-memory address `dst` that
// does not wait for the load; with n = 0 it reads nothing and writes a zero.
__device__ __forceinline__ void cp_async_f32(unsigned dst, const float* src, int n = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// Wait for this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds4(const float* smem, int off) {
  return *reinterpret_cast<const float4*>(smem + off);
}

__device__ __forceinline__ void sts4(float* smem, int off, float4 v) {
  *reinterpret_cast<float4*>(smem + off) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Both kernels reach their tiles as smem[offset], never through a pointer: a
// generic pointer into shared memory costs an address conversion at every
// load.
__global__ void __launch_bounds__(kWarps * 32)
gram_logdet_fwd_kernel(const float* __restrict__ jac, float* __restrict__ gram,
                       float* __restrict__ logdet, float* __restrict__ chol,
                       int d, int B, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a tail warp leaves before any __syncwarp
  const int dp = tile_rows(d), S = tile_stride(d);
  const int J = warp * fwd_tile_floats(d, D);
  const int A = J + D * S;

  // 1. Copy J, J[k·S + i] = jac[i, b, k], with cp.async: each row is D
  //    contiguous floats, and the rows past d are zero-filled by the same
  //    copies.
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  for (int i = 0; i < dp; ++i) {
    const bool row = i < d;
    const float* src = jac + ((size_t)(row ? i : 0) * B + b) * D;
    for (int k = lane; k < D; k += 32) cp_async_f32(sbase + 4u * (J + k * S + i), src + k, row ? 4 : 0);
  }
  cp_async_wait_all();
  __syncwarp();

  // 2. The Gram, a 4×4 block (ib, jb), ib ≥ jb, a lane: 16 independent sums
  //    over k in order, then the block and its transpose into A. The pad
  //    rows of J are zero, so A's pad rows and columns are zero; its pad
  //    diagonal is set to 1.
  const int nb = dp / R;
  for (int q = lane; q < nb * (nb + 1) / 2; q += 32) {
    int ib = 0;
    while ((ib + 1) * (ib + 2) / 2 <= q) ++ib;
    const int jb = q - ib * (ib + 1) / 2;
    const int Ji = J + ib * R, Jj = J + jb * R;
    float acc[R][R] = {};
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float4 u = lds4(smem, Ji + k * S), v = lds4(smem, Jj + k * S);
      const float x[R] = {u.x, u.y, u.z, u.w}, y[R] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
      }
    }
    if (ib == jb) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (ib * R + r >= d) acc[r][r] = 1.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sts4(smem, A + (ib * R + r) * S + jb * R, float4{acc[r][0], acc[r][1], acc[r][2], acc[r][3]});
      if (ib != jb) sts4(smem, A + (jb * R + r) * S + ib * R, float4{acc[0][r], acc[1][r], acc[2][r], acc[3][r]});
    }
  }
  __syncwarp();

  // 3. Store G: element q = i·d + j of the d·d contiguous floats, the lanes
  //    on neighbouring q, stepping (i, j) without a division.
  float* gb = gram + (size_t)b * d * d;
  float* lb = chol + (size_t)b * d * d;
  const int lane_i = lane / d, lane_j = lane - lane_i * d;
  const int step_i = 32 / d, step_j = 32 - step_i * d;
  for (int q = lane, i = lane_i, j = lane_j; q < d * d; q += 32) {
    gb[q] = smem[A + i * S + j];
    i += step_i;
    j += step_j;
    if (j >= d) { j -= d; ++i; }
  }
  __syncwarp();  // A is overwritten from here on

  // 4. Cholesky in 4-column panels j0 = 0, 4, …; lane `row` owns row `row`
  //    of A. The panel's pivots s_r, reciprocal roots q_r and its triangle
  //    l_rc are the same in every lane.
  const int row = lane;
  const int Ar = A + row * S;
  const bool mine = row < dp;
  float ld = 0.f;
  for (int j0 = 0; j0 < dp; j0 += R) {
    // a = A[row][j0..j0+3] less Σ_{k<j0} L[row][k]·L[j0+r][k], four chains
    // over k in order.
    float4 a = {};
    if (mine && row >= j0) {
      a = lds4(smem, Ar + j0);
      const int P = A + j0 * S;
#pragma unroll 2
      for (int k = 0; k < j0; k += 4) {
        const float4 l = lds4(smem, Ar + k);
        const float4 p0 = lds4(smem, P + k), p1 = lds4(smem, P + S + k);
        const float4 p2 = lds4(smem, P + 2 * S + k), p3 = lds4(smem, P + 3 * S + k);
        a.x = -dot4(l, p0, -a.x);
        a.y = -dot4(l, p1, -a.y);
        a.z = -dot4(l, p2, -a.z);
        a.w = -dot4(l, p3, -a.w);
      }
    }
    // The panel's 4×4 diagonal triangle from lanes j0..j0+3, factored.
    const float t00 = __shfl_sync(kFullMask, a.x, j0);
    const float t10 = __shfl_sync(kFullMask, a.x, j0 + 1), t11 = __shfl_sync(kFullMask, a.y, j0 + 1);
    const float t20 = __shfl_sync(kFullMask, a.x, j0 + 2), t21 = __shfl_sync(kFullMask, a.y, j0 + 2);
    const float t22 = __shfl_sync(kFullMask, a.z, j0 + 2);
    const float t30 = __shfl_sync(kFullMask, a.x, j0 + 3), t31 = __shfl_sync(kFullMask, a.y, j0 + 3);
    const float t32 = __shfl_sync(kFullMask, a.z, j0 + 3), t33 = __shfl_sync(kFullMask, a.w, j0 + 3);
    const float s0 = t00, q0 = rsqrtf(s0);
    const float l10 = t10 * q0, l20 = t20 * q0, l30 = t30 * q0;
    const float s1 = fmaf(-l10, l10, t11), q1 = rsqrtf(s1);
    const float l21 = fmaf(-l20, l10, t21) * q1, l31 = fmaf(-l30, l10, t31) * q1;
    const float s2 = fmaf(-l21, l21, fmaf(-l20, l20, t22)), q2 = rsqrtf(s2);
    const float l32 = fmaf(-l31, l21, fmaf(-l30, l20, t32)) * q2;
    const float s3 = fmaf(-l32, l32, fmaf(-l31, l31, fmaf(-l30, l30, t33))), q3 = rsqrtf(s3);
    ld += logf(s0);
    ld += logf(s1);
    ld += logf(s2);
    ld += logf(s3);
    // Row `row`'s four entries of L: below the panel, solved against the
    // triangle; in it, the triangle's row (zero above the diagonal).
    if (mine && row >= j0) {
      float4 l;
      switch (row - j0) {
        case 0: l = float4{s0 * q0, 0.f, 0.f, 0.f}; break;
        case 1: l = float4{l10, s1 * q1, 0.f, 0.f}; break;
        case 2: l = float4{l20, l21, s2 * q2, 0.f}; break;
        case 3: l = float4{l30, l31, l32, s3 * q3}; break;
        default:
          l.x = a.x * q0;
          l.y = fmaf(-l10, l.x, a.y) * q1;
          l.z = fmaf(-l21, l.y, fmaf(-l20, l.x, a.z)) * q2;
          l.w = fmaf(-l32, l.z, fmaf(-l31, l.y, fmaf(-l30, l.x, a.w))) * q3;
      }
      sts4(smem, Ar + j0, l);
    }
    __syncwarp();
  }

  // 5. Store L, zero above the diagonal (A still holds G there), and the
  //    log-det.
  for (int q = lane, i = lane_i, j = lane_j; q < d * d; q += 32) {
    lb[q] = j <= i ? smem[A + i * S + j] : 0.f;
    i += step_i;
    j += step_j;
    if (j >= d) { j -= d; ++i; }
  }
  if (lane == 0) logdet[b] = ld;
}

// One step of four m of the M·J sums of a group of R rows starting at the
// shared offset Mi0: acc[c] += M[i0..i0+3][m..m+3]·J_c[m..m+3].
template <int NC>
__device__ __forceinline__ void mj_step(const float* smem, const int (&Jc)[NC], bool last_on,
                                        int Mi0, int S, int m, float4 (&acc)[NC]) {
  float4 x[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) x[c] = (c < NC - 1 || last_on) ? lds4(smem, Jc[c] + m) : float4{};
  const float4 m0 = lds4(smem, Mi0 + m), m1 = lds4(smem, Mi0 + S + m);
  const float4 m2 = lds4(smem, Mi0 + 2 * S + m), m3 = lds4(smem, Mi0 + 3 * S + m);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    acc[c].x = dot4(m0, x[c], acc[c].x);
    acc[c].y = dot4(m1, x[c], acc[c].y);
    acc[c].z = dot4(m2, x[c], acc[c].z);
    acc[c].w = dot4(m3, x[c], acc[c].w);
  }
}

// Rows i0..i0+3 (those below d) of dJ for the lane's columns: each row is D
// contiguous floats of the (d, B, D) output.
template <int NC>
__device__ __forceinline__ void store_rows(float* djac, const float4 (&acc)[NC], bool last_on,
                                           int lane, int b, int B, int D, int d, int i0) {
  const size_t row = (size_t)B * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == NC - 1 && !last_on) continue;
    float* out = djac + i0 * row + (size_t)b * D + lane + 32 * c;
    out[0] = acc[c].x;
    if (i0 + 1 < d) out[row] = acc[c].y;
    if (i0 + 2 < d) out[2 * row] = acc[c].z;
    if (i0 + 3 < d) out[3 * row] = acc[c].w;
  }
}

// NC = ceil(D / 32): the columns each lane owns, k = lane + 32·c.
template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
gram_logdet_bwd_kernel(const float* __restrict__ jac, const float* __restrict__ chol,
                       const float* __restrict__ gbar, const float* __restrict__ ldbar,
                       float* __restrict__ djac, int d, int B, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a tail warp leaves before any __syncwarp
  // The tiles, padded with zeros to dp rows. J and W hold column k of the
  // element at k·S, so a lane walks its own columns at unit stride, four
  // rows a load. T holds L strictly below the diagonal, Lᵀ strictly above it
  // and 1/L[i][i] on it: row i of T is what row i of either solve reads.
  const int dp = tile_rows(d), S = tile_stride(d);
  const int J = warp * bwd_tile_floats(d, D);
  const int W = J + D * S;
  const int T = W + D * S;
  const int M = T + dp * S;
  const int GT = M + dp * S;
  const float g_ld = ldbar[b];
  const bool solve = g_ld != 0.f;  // the same for every lane of the warp
  const float* lb = chol + (size_t)b * d * d;
  const float* gbb = gbar + (size_t)b * d * d;

  // 1. Copy J (each row D contiguous floats), Ḡ and Ḡᵀ, and, where the
  //    solves run, the lower triangle of L (the upper one is never read) into
  //    T both as it is and transposed, with cp.async, so that all of a
  //    lane's loads are in flight at once. Rows and columns past d are
  //    zero-filled by the same copies.
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  for (int i = 0; i < dp; ++i) {
    const bool row = i < d;
    const float* src = jac + ((size_t)(row ? i : 0) * B + b) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = lane + 32 * c;
      if (k < D) {
        cp_async_f32(sbase + 4u * (J + k * S + i), src + k, row ? 4 : 0);
        if (!row) smem[W + k * S + i] = 0.f;
      }
    }
    if (lane < dp) {
      const bool in = row && lane < d;
      const float* g = gbb + (in ? i * d + lane : 0);
      cp_async_f32(sbase + 4u * (M + i * S + lane), g, in ? 4 : 0);
      cp_async_f32(sbase + 4u * (GT + lane * S + i), g, in ? 4 : 0);
      if (solve) {
        // T[i][j] above the diagonal comes from the transposed copy of row j.
        const float* l = lb + (in ? i * d + lane : 0);
        if (!in || lane <= i) cp_async_f32(sbase + 4u * (T + i * S + lane), l, in ? 4 : 0);
        if (in && lane < i) cp_async_f32(sbase + 4u * (T + lane * S + i), l);
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();
  // 2. M = Ḡ + Ḡᵀ, lane j over column j, R rows a step (all loads before
  //    the stores); 1/L[j][j] on T's diagonal.
  if (lane < d) {
    const int j = lane;
    for (int i0 = 0; i0 < d; i0 += R) {
      float g[R], gt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        g[r] = smem[M + (i0 + r) * S + j];
        gt[r] = smem[GT + (i0 + r) * S + j];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) smem[M + (i0 + r) * S + j] = g[r] + gt[r];
    }
    if (solve) smem[T + j * S + j] = 1.f / smem[T + j * S + j];
  }
  __syncwarp();

  // From here each lane reads and writes only its own columns of J and W;
  // only the last of its NC columns can lie past D. Every row range is a
  // whole number of R-row groups: the zero pads stand in for rows past d.
  int Jc[NC], Wc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    Jc[c] = J + (lane + 32 * c) * S;
    Wc[c] = W + (lane + 32 * c) * S;
  }
  const bool last_on = lane + 32 * (NC - 1) < D;
#define CMF_ON(c) ((c) < NC - 1 || last_on)
  static_assert(R == 4, "the row groups are float4 loads");

  if (solve) {
    // 3. Y = L⁻¹J into W, R rows at a time: first what the rows above the
    //    group contribute (independent sums that share each load of Y), then
    //    the R×R triangle in registers.
    for (int i0 = 0; i0 < dp; i0 += R) {
      float4 acc[NC], tri[R];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = CMF_ON(c) ? lds4(smem, Jc[c] + i0) : float4{};
#pragma unroll
      for (int r = 0; r < R; ++r) tri[r] = lds4(smem, T + (i0 + r) * S + i0);
#pragma unroll 2
      for (int m = 0; m < i0; m += 4) {
        float4 y[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) y[c] = CMF_ON(c) ? lds4(smem, Wc[c] + m) : float4{};
        const float4 l0 = lds4(smem, T + i0 * S + m), l1 = lds4(smem, T + (i0 + 1) * S + m);
        const float4 l2 = lds4(smem, T + (i0 + 2) * S + m), l3 = lds4(smem, T + (i0 + 3) * S + m);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c].x = -dot4(l0, y[c], -acc[c].x);
          acc[c].y = -dot4(l1, y[c], -acc[c].y);
          acc[c].z = -dot4(l2, y[c], -acc[c].z);
          acc[c].w = -dot4(l3, y[c], -acc[c].w);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4& a = acc[c];
        a.x *= tri[0].x;
        a.y = (a.y - tri[1].x * a.x) * tri[1].y;
        a.z = (a.z - tri[2].x * a.x - tri[2].y * a.y) * tri[2].z;
        a.w = (a.w - tri[3].x * a.x - tri[3].y * a.y - tri[3].z * a.z) * tri[3].w;
        if (CMF_ON(c)) *reinterpret_cast<float4*>(smem + Wc[c] + i0) = a;
      }
    }

    // 4. Z = L⁻ᵀY in place on W, R rows at a time from the bottom: what the
    //    rows below the group contribute, then the triangle in registers.
    //    The group's rows of M·J are summed in the same loops, so that the
    //    two sums' loads overlap, and dJ = M·J + 2·ḡ_ld·Z is written at once.
    const float two_g = 2.f * g_ld;
    for (int i0 = dp - R; i0 >= 0; i0 -= R) {
      float4 z[NC], acc[NC], tri[R];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        z[c] = CMF_ON(c) ? lds4(smem, Wc[c] + i0) : float4{};
        acc[c] = float4{};
      }
#pragma unroll
      for (int r = 0; r < R; ++r) tri[r] = lds4(smem, T + (i0 + r) * S + i0);
#pragma unroll 2
      for (int m = 0; m < i0 + R; m += 4) mj_step<NC>(smem, Jc, last_on, M + i0 * S, S, m, acc);
#pragma unroll 2
      for (int m = i0 + R; m < dp; m += 4) {
        float4 y[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) y[c] = CMF_ON(c) ? lds4(smem, Wc[c] + m) : float4{};
        // T's row i above the diagonal is column i of L: L[m][i].
        const float4 l0 = lds4(smem, T + i0 * S + m), l1 = lds4(smem, T + (i0 + 1) * S + m);
        const float4 l2 = lds4(smem, T + (i0 + 2) * S + m), l3 = lds4(smem, T + (i0 + 3) * S + m);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          z[c].x = -dot4(l0, y[c], -z[c].x);
          z[c].y = -dot4(l1, y[c], -z[c].y);
          z[c].z = -dot4(l2, y[c], -z[c].z);
          z[c].w = -dot4(l3, y[c], -z[c].w);
        }
        mj_step<NC>(smem, Jc, last_on, M + i0 * S, S, m, acc);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4& a = z[c];
        a.w *= tri[3].w;
        a.z = (a.z - tri[2].w * a.w) * tri[2].z;
        a.y = (a.y - tri[1].z * a.z - tri[1].w * a.w) * tri[1].y;
        a.x = (a.x - tri[0].y * a.y - tri[0].z * a.z - tri[0].w * a.w) * tri[0].x;
        if (CMF_ON(c)) *reinterpret_cast<float4*>(smem + Wc[c] + i0) = a;
        acc[c] = float4{fmaf(two_g, a.x, acc[c].x), fmaf(two_g, a.y, acc[c].y),
                        fmaf(two_g, a.z, acc[c].z), fmaf(two_g, a.w, acc[c].w)};
      }
      store_rows<NC>(djac, acc, last_on, lane, b, B, D, d, i0);
    }
  } else {
    // 5. Without the solves, dJ = M·J alone, R rows at a time.
    for (int i0 = 0; i0 < dp; i0 += R) {
      float4 acc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = float4{};
#pragma unroll 2
      for (int m = 0; m < dp; m += 4) mj_step<NC>(smem, Jc, last_on, M + i0 * S, S, m, acc);
      store_rows<NC>(djac, acc, last_on, lane, b, B, D, d, i0);
    }
  }
#undef CMF_ON
}

bool shape_ok(int d, int B, int D) {
  return d >= 1 && d <= kMaxD && D >= 1 && D <= kMaxAmb && B >= 1;
}

constexpr int kMaxDevices = 64;

// The opt-in above 48 KB of dynamic shared memory is an attribute of a
// kernel function on the current device. It is set once a device and
// function, to the most that function can ask; `done` holds that function's
// flags, one a device.
int opt_in_smem(const void* kernel, int bytes, std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool known = dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_relaxed)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_relaxed);
  return (int)err;
}

int launch_fwd(const float* jac, float* gram, float* logdet, float* chol, int d, int B, int D,
               cudaStream_t stream) {
  const int smem = fwd_smem_bytes(d, D);
  if (smem > 48 * 1024) {
    static std::atomic<bool> done[kMaxDevices];
    const int err = opt_in_smem(reinterpret_cast<const void*>(gram_logdet_fwd_kernel),
                                fwd_smem_bytes(kMaxD, kMaxAmb), done);
    if (err != 0) return err;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  gram_logdet_fwd_kernel<<<blocks, kWarps * 32, smem, stream>>>(jac, gram, logdet, chol, d, B, D);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_bwd(const float* jac, const float* chol, const float* gbar, const float* ldbar,
               float* djac, int d, int B, int D, cudaStream_t stream) {
  const int smem = bwd_smem_bytes(d, D);
  if (smem > 48 * 1024) {
    // The most this instance can ask: d = kMaxD, D = 32·NC.
    static std::atomic<bool> done[kMaxDevices];
    const int err = opt_in_smem(reinterpret_cast<const void*>(gram_logdet_bwd_kernel<NC>),
                                bwd_smem_bytes(kMaxD, 32 * NC), done);
    if (err != 0) return err;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  gram_logdet_bwd_kernel<NC><<<blocks, kWarps * 32, smem, stream>>>(jac, chol, gbar, ldbar,
                                                                    djac, d, B, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// fp32 tensors: jac (d, B, D); gram, chol, gbar (B, d, d); logdet, ldbar (B,);
// djac (d, B, D). The kernel runs on `stream`; the return value is
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cmf_gram_logdet_fwd(const void* jac, void* gram, void* logdet, void* chol,
                                   int d, int B, int D, void* stream) {
  if (!shape_ok(d, B, D)) return (int)cudaErrorInvalidValue;
  return launch_fwd((const float*)jac, (float*)gram, (float*)logdet, (float*)chol, d, B, D,
                    (cudaStream_t)stream);
}

extern "C" int cmf_gram_logdet_bwd(const void* jac, const void* chol, const void* gbar,
                                   const void* ldbar, void* djac, int d, int B, int D,
                                   void* stream) {
  if (!shape_ok(d, B, D)) return (int)cudaErrorInvalidValue;
  const float *j = (const float*)jac, *l = (const float*)chol;
  const float *g = (const float*)gbar, *ld = (const float*)ldbar;
  float* dj = (float*)djac;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return launch_bwd<1>(j, l, g, ld, dj, d, B, D, s);
    case 2: return launch_bwd<2>(j, l, g, ld, dj, d, B, D, s);
    case 3: return launch_bwd<3>(j, l, g, ld, dj, d, B, D, s);
    default: return launch_bwd<4>(j, l, g, ld, dj, d, B, D, s);
  }
}

// Both kernels' launch geometry at (d, D): warps a block (the same for both)
// and each one's dynamic shared bytes a block.
extern "C" void cmf_gram_logdet_geometry(int d, int D, int* warps, int* fwd_smem,
                                         int* bwd_smem) {
  *warps = kWarps;
  *fwd_smem = fwd_smem_bytes(d, D);
  *bwd_smem = bwd_smem_bytes(d, D);
}
