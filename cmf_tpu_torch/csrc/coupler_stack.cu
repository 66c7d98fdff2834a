// Fused ResNet-coupler forward for the multiscale image couplings, written
// for Hopper (sm_90a).
//
// Replaces the Pallas/TPU kernel cmf_tpu/ops/pallas/coupler_stack.py::_kernel
// (:124, launched by _call :166 through fused_resnet_coupler :198), in its
// default arithmetic (bf16=False, stack_taps=False): fp32 operands, fp32 sums.
//
// Per image b, with hidden width Hd and K residual blocks, it computes
// ResNet.apply of the batchnorm-free coupler net (cmf_tpu/nets/core.py:271):
//   h   = conv3x3(x)                                   (bias-free conv_in)
//   h  += conv3x3(relu(conv3x3(relu(h)) + b1)) + b2    (K times)
//   out = head_w · tanh(conv1x1(relu(h)) + b_out) + head_b
// Every 3×3 conv is a cross-correlation with zero padding at the image
// border: the 9 taps (dy, dx) ∈ {-1,0,1}² read the source pixel (y+dy, x+dx)
// where it lies inside the image and 0 elsewhere, as the TPU kernel's tap
// masks do (coupler_stack.py:70-80).
//
// Design. The TPU kernel keeps channels on sublanes and flattened,
// 128-padded pixels on lanes, and runs each conv as 9 rolled, masked
// (64×64)·(64, L) matmuls in VMEM. None of that carries over. Here one thread
// block owns one image and walks all 2K+2 layers with a barrier between
// them, so the whole coupler is one launch. The residual stream h and one
// temporary t live in a global scratch of 2·Hd·H·W floats per image, sized
// by the wrapper from the batch (100 MB at B=250, 28×28, Hd=64); a block
// re-reads its own maps, which stay in the SM's L1 and the 50 MB L2. A warp
// owns 8 output channels × 128 pixels: each lane accumulates 8 channels for
// 4 pixels 32 apart, so the input loads of a warp are coalesced and the 8
// weights of one (input channel, tap) are two float4 loads that every lane of
// the warp shares. Weights come repacked as [input channel][tap][output
// channel] through the read-only path.
//
// Bound on an H100 SXM: operations. A 28×28 coupler with Hd=64, K=8 is
// ~926 MFLOP per image (2·9·64·64·784 per 3×3 conv, 16 of them), 46.3 GFLOP
// at B=50, against ~2.8 MB of weights, images and outputs that must move:
// 0.69 ms at the 67 TFLOP/s fp32 peak (no tensor cores), ~1 µs of bytes. What holds this version back: one
// block per image leaves 82 of 132 SMs idle at B=50, and the FMAs run on the
// fp32 pipes with a load for every 5 of them. Thread-block clusters that
// split an image over several SMs, and tensor cores (the bf16 / stack_taps
// variants), are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOcTile = 8;                 // output channels per lane
constexpr int kPx = 4;                     // pixels per lane, 32 apart
constexpr int kPxGroup = 32 * kPx;         // pixels per warp work item

// out[o][p] (+)= bias[o] + Σ_tap Σ_i wt[i][tap][o] · act(in[i][p + tap]),
// act = relu when kReluIn. O must be a multiple of kOcTile. `in` and `out`
// are maps this kernel writes, so they are read through the coherent path.
template <bool kReluIn, bool kAccumulate>
__device__ __forceinline__ void conv3x3(const float* in, int I, const float* __restrict__ wt,
                                        const float* __restrict__ bias, float* out, int O,
                                        int H, int W) {
  const int P = H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_oc = O / kOcTile;
  const int n_items = n_oc * ((P + kPxGroup - 1) / kPxGroup);
  for (int item = warp; item < n_items; item += n_warps) {
    const int oc0 = (item % n_oc) * kOcTile;
    const int p0 = (item / n_oc) * kPxGroup + lane;
    int py[kPx], px[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const int p = p0 + 32 * k;
      py[k] = p < P ? p / W : -2;  // a pixel past the end: every tap masked
      px[k] = p % W;
    }
    float acc[kPx][kOcTile];
#pragma unroll
    for (int k = 0; k < kPx; ++k)
#pragma unroll
      for (int c = 0; c < kOcTile; ++c) acc[k][c] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      int off[kPx];
      bool ok[kPx];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const int y = py[k] + dy, x = px[k] + dx;
        ok[k] = y >= 0 && y < H && x >= 0 && x < W;
        off[k] = ok[k] ? y * W + x : 0;
      }
      const float* src = in;
      const float* w = wt + tap * O + oc0;
      for (int i = 0; i < I; ++i, src += P, w += 9 * O) {
        float v[kPx];
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          const float a = ok[k] ? src[off[k]] : 0.f;
          v[k] = kReluIn ? fmaxf(a, 0.f) : a;
        }
        const float4 wa = __ldg(reinterpret_cast<const float4*>(w));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(w + 4));
        const float wv[kOcTile] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int k = 0; k < kPx; ++k)
#pragma unroll
          for (int c = 0; c < kOcTile; ++c) acc[k][c] = fmaf(wv[c], v[k], acc[k][c]);
      }
    }

#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const int p = p0 + 32 * k;
      if (p >= P) continue;
#pragma unroll
      for (int c = 0; c < kOcTile; ++c) {
        const int o = oc0 + c;
        float r = acc[k][c] + (bias != nullptr ? __ldg(bias + o) : 0.f);
        float* dst = out + (size_t)o * P + p;
        if (kAccumulate) r += *dst;
        *dst = r;
      }
    }
  }
}

// out[o][p] = head_w[o] · tanh(Σ_i w[i][o] · relu(h[i][p]) + b[o]) + head_b[o].
__device__ __forceinline__ void conv1x1_head(const float* h, int Hd, const float* __restrict__ w,
                                             const float* __restrict__ b,
                                             const float* __restrict__ head_w,
                                             const float* __restrict__ head_b,
                                             float* __restrict__ out, int C_out, int P) {
  for (int q = threadIdx.x; q < C_out * P; q += blockDim.x) {
    const int o = q / P, p = q - o * P;
    float acc = 0.f;
    for (int i = 0; i < Hd; ++i) acc = fmaf(__ldg(w + i * C_out + o), fmaxf(h[(size_t)i * P + p], 0.f), acc);
    out[q] = __ldg(head_w + o) * tanhf(acc + __ldg(b + o)) + __ldg(head_b + o);
  }
}

// Packed weights, in order: w_in [C_in][9][Hd]; per block w1 [Hd][9][Hd],
// b1 [Hd], w2 [Hd][9][Hd], b2 [Hd]; w_out [Hd][C_out], b_out, head_w,
// head_b [C_out]. Every 3×3 segment starts at a multiple of 8 floats.
__global__ void __launch_bounds__(kThreads)
coupler_stack_kernel(const float* __restrict__ x, const float* __restrict__ weights,
                     float* __restrict__ out, float* scratch, int C_in, int H, int W, int Hd,
                     int num_blocks, int C_out) {
  const int b = blockIdx.x;
  const int P = H * W;
  const float* xb = x + (size_t)b * C_in * P;
  float* h = scratch + (size_t)b * 2 * Hd * P;
  float* t = h + (size_t)Hd * P;
  const size_t w33 = (size_t)Hd * 9 * Hd;

  const float* w = weights;
  conv3x3<false, false>(xb, C_in, w, nullptr, h, Hd, H, W);
  w += (size_t)C_in * 9 * Hd;
  __syncthreads();
  for (int k = 0; k < num_blocks; ++k) {
    const float* w1 = w;
    const float* b1 = w1 + w33;
    const float* w2 = b1 + Hd;
    const float* b2 = w2 + w33;
    w = b2 + Hd;
    conv3x3<true, false>(h, Hd, w1, b1, t, Hd, H, W);
    __syncthreads();
    conv3x3<true, true>(t, Hd, w2, b2, h, Hd, H, W);
    __syncthreads();
  }
  const float* w_out = w;
  const float* b_out = w_out + (size_t)Hd * C_out;
  conv1x1_head(h, Hd, w_out, b_out, b_out + C_out, b_out + 2 * C_out,
               out + (size_t)b * C_out * P, C_out, P);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// fp32 tensors: x (B, C_in, H, W); weights packed as above; out
// (B, C_out, H, W); scratch (B, 2, Hd, H, W). Hd must be a positive multiple
// of 8. The kernel runs on `stream`; the return value is cudaGetLastError()
// after the launch (0 = launched).
extern "C" int cmf_coupler_stack_fwd(const void* x, const void* weights, void* out, void* scratch,
                                     int B, int C_in, int H, int W, int Hd, int num_blocks,
                                     int C_out, void* stream) {
  if (B < 1 || C_in < 1 || H < 1 || W < 1 || Hd < kOcTile || Hd % kOcTile != 0 ||
      num_blocks < 0 || C_out < 1)
    return (int)cudaErrorInvalidValue;
  coupler_stack_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)weights, (float*)out, (float*)scratch, C_in, H, W, Hd,
      num_blocks, C_out);
  return (int)cudaGetLastError();
}
