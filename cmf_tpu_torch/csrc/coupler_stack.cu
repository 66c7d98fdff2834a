// Fused ResNet-coupler forward for the multiscale image couplings, written
// for Hopper (sm_90a).
//
// Replaces the Pallas/TPU kernel cmf_tpu/ops/pallas/coupler_stack.py::_kernel
// (:124, launched by _call :169 through fused_resnet_coupler :198), in both
// its arithmetics. bf16=False (cmf_coupler_stack_fwd): fp32 inputs, weights,
// biases, residual stream, outputs and sums. bf16=True
// (cmf_coupler_stack_fwd_bf16, :83-147): every 3×3 conv, conv_in included,
// multiplies the bf16-rounded shifted map by the bf16-rounded weight and sums
// in fp32; the residual stream, the biases, the 1×1 conv and the head stay
// fp32.
//
// Per image b, with hidden width Hd and K residual blocks, it computes
// ResNet.apply of the batchnorm-free coupler net (cmf_tpu/nets/core.py:271):
//   h   = conv3x3(x)                                   (bias-free conv_in)
//   h  += conv3x3(relu(conv3x3(relu(h)) + b1)) + b2    (K times)
//   out = head_w · tanh(conv1x1(relu(h)) + b_out) + head_b
// Every 3×3 conv is a cross-correlation with zero padding at the image
// border, as the TPU kernel's tap masks give (coupler_stack.py:70-80).
//
// Bound on an H100 SXM: operations. A 28×28 coupler with Hd=64, K=8 is
// ~926 MFLOP an image, 16 of its 17 convs Hd×Hd 3×3. On the tensor cores in
// 3×TF32 (below) that is 3·FLOP at 495 TFLOP/s: 1.40 ms at B=250, against
// 3.46 ms at the 67 TFLOP/s of the fp32 pipes. Single-pass TF32 is ~1e-2
// off the fp32 result, so every Hd×Hd conv splits each operand into a TF32
// high part and a TF32 low part and sums lo·hi + hi·lo + hi·hi in fp32
// (mma.sync m16n8k8 TF32), which stays in fp32's accuracy class.
//
// Design.
// - One image is one thread-block cluster of N CTAs (N ≤ 16). CTA r owns
//   image rows [r·H/N, (r+1)·H/N) across all channels. Its band of the
//   residual stream h and of the temporary t lives in shared memory for all
//   17 convs: no device-memory scratch. Each map is [Hd][S] floats with rows
//   of W+1 (one zero column shared between neighbouring rows) and one halo
//   row above and below the band; a 3×3 tap is then a constant offset and no
//   masks are needed. S ≡ 8 or 24 (mod 32), so the 4 channels × 8 pixels of
//   a B fragment load fall in 32 different banks.
// - Before a conv reads a map, the CTA copies its two halo rows out of the
//   neighbouring CTAs' shared memory (distributed shared memory, after a
//   cluster barrier). Two cluster barriers per residual block: after conv1
//   writes t, and after conv2 adds into h.
// - Each Hd×Hd 3×3 conv is an implicit GEMM out[Hd × P] = W[Hd × 9Hd] ·
//   X[9Hd × P], K ordered (tap, input channel), as the TPU kernel's
//   stack_taps operand (coupler_stack.py:99-109). 16 warps a CTA, 2 along
//   the output channels (Hd padded to 32 or 64) and 8 along the band's
//   pixels: a warp owns Hd/32 m-tiles of 16 channels and 1-4 n-tiles of 8
//   pixels, a compile-time count, so its inner loop has no branch and fits
//   the 128 registers a thread of 512 may hold, and 4 warps on each SM
//   sub-partition hide each other's load and mma latencies. The weights come
//   split into
//   hi/lo TF32 by the wrapper, packed in mma fragment order (one 16-byte
//   load per lane per m-tile and k-step), and stream through a 3-stage
//   cp.async ring in chunks of one tap × 16 or 32 input channels, while the
//   tensor cores work on the chunk before. The ring runs across conv
//   boundaries.
// - The tensor cores truncate as they accumulate, so the mmas of each span
//   of 4 k-steps (32 input channels of a tap) sum into a fresh partial that
//   the fp32 pipes add into the running sum (conv3x3_mma).
// - conv_in (K = 9·C_in) and the 1×1 conv with its tanh head are small and
//   stay on the fp32 pipes.
//
// The bf16 variant (template parameter BF) keeps all of this but the
// arithmetic of the Hd×Hd convs: one mma.sync m16n8k16 bf16 pass with fp32
// sums, no hi/lo split, the weights packed by the wrapper as bf16 fragments
// (ops/coupler_stack.py::bf16_fragments) and the activations rounded to bf16
// (to nearest, ties to even, as astype) as they are loaded into fragments.
// The mma's k index 8r + 2·tig + j stands for input channel 8r + tig + 4j,
// so a lane loads the channels the TF32 path's lane loads. conv_in runs on
// the fp32 pipes on the bf16-rounded input and weights (exact products).
// Bound: 926 MFLOP an image at 989 TFLOP/s, 0.234 ms at B=250.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarpsN = kThreads / 32 / 2;           // warps along the pixels; 2 along the channels
constexpr int kMaxTiles = 4;                         // n-tiles of 8 pixels per warp
constexpr int kMaxPixels = kWarpsN * kMaxTiles * 8;  // pixels per CTA band
constexpr int kStages = 3;                           // weight ring depth
constexpr int kSpan = 4;                             // k-steps a partial sum spans
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;

struct Args {
  const float* x;      // (B, C_in, H, W)
  const float* frags;  // hi/lo TF32 (or bf16) fragments of the 2K Hd×Hd convs, in stream order
  const float* small;  // w_in [C_in][9][Hd]; biases [2K][Hd]; w_out [Hd][C_out]; b_out, head_w, head_b
  float* out;          // (B, C_out, H, W)
  int C_in, H, W, Hd, num_blocks, C_out, cluster, S, kc;
};

// Where a CTA's band sits and how its maps are laid out.
struct Band {
  int rank, img, r0, rows, P, Wp;
  __device__ int addr(int p, int W) const {  // map index of band pixel p
    const int r = p / W;
    return 1 + (r + 1) * Wp + (p - r * W);
  }
};

__device__ __forceinline__ int band_start(int rank, int H, int N) { return rank * H / N; }

// What cvt.rna.tf32.f32 gives for an x that is not NaN: round to 10
// mantissa bits, ties away from zero (ops/coupler_stack.py::tf32_round).
// Two integer ops, where the cvt instruction costs several.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The same with a zero accumulator in: d = a·b.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
}

// Two fp32 values rounded to bf16 (to nearest, ties to even) in one
// register, lo in the low half: a bf16x2 operand of mma.sync.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte copies in one weight chunk: KC input channels × 32·MW outputs ×
// hi/lo floats in the TF32 stream, a quarter of that in the bf16 one (2
// bytes a weight, no lo part).
template <int MW, int KC, bool BF>
__host__ __device__ constexpr int chunk_vecs() {
  return BF ? KC * 32 * MW / 8 : KC * 32 * MW * 2 / 4;
}

// The weight stream: chunk c of `total` goes to ring stage c % kStages.
struct Ring {
  float* base;
  const float* src;
  int chunk_floats, total;
  // kVec 16-byte copies a chunk (chunk_floats == 4 · kVec): a whole number
  // a thread, or one for each of the first kVec threads (the bf16 stream).
  // The bf16 stream's loop runs to the runtime count: a compile-time guard
  // there took the main-path bf16 instance to the 128-register cap with a
  // spill, 8% slower on an H100.
  template <int kVec>
  __device__ __forceinline__ void issue(int c) const {
    static_assert(kVec % kThreads == 0 || kVec < kThreads, "a chunk splits evenly over the threads");
    if (c < total) {
      const float4* g = reinterpret_cast<const float4*>(src + (size_t)c * chunk_floats);
      float4* s = reinterpret_cast<float4*>(base + (c % kStages) * chunk_floats);
      if constexpr (kVec % kThreads == 0) {
#pragma unroll
        for (int q = 0; q < kVec / kThreads; ++q) cp_async16(s + q * kThreads + threadIdx.x, g + q * kThreads + threadIdx.x);
      } else {
        for (int q = threadIdx.x; q < chunk_floats / 4; q += kThreads) cp_async16(s + q, g + q);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  }
};

// dst[o][p] (+)= bias[o] + Σ_{tap,i} W[o][tap,i] · relu(src[i][p + tap]) over
// the band on the tensor cores: 3×TF32, or with BF one m16n8k16 bf16 mma a
// k-step of 16 input channels and tile pair, A from the ring (bf16
// fragments) and B rounded from the map. Consumes 9·Hd/KC ring chunks.
//
// Warp w owns m-tiles (w % 2)·MW .. +MW (MW·16 output channels) and the n
// tiles w/2 + 8·j, j < NT, of 8 band pixels each. A tile past the band reads
// a clamped pixel and is not stored, so every warp runs the same mmas and
// no branch splits the inner loop.
//
// The tensor cores add into their fp32 accumulator with truncation, so 72
// k-steps of 3 mmas into one running sum drift by ~1e-4 over the 16 convs
// (max error / max |out| on the card, against ~7e-6 in fp32). The mmas of
// each span of kSpan k-steps go into a fresh partial sum instead, which the
// fp32 pipes add into the running sum (round to nearest): ~1e-5. The mmas of
// a k-step are issued term by term over all (m, n) tile pairs, so two mmas
// into the same partial are MW·NT issues apart. The bf16 mmas of a chunk
// sum into one fresh partial the same way.
template <int MW, int NT, int KC, bool BF>
__device__ __forceinline__ void conv3x3_mma(const float* src, float* dst, bool accumulate,
                                            const float* __restrict__ bias, const Args& a,
                                            const Band& band, const Ring& ring, int& chunk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp & 1) * MW, n0 = warp >> 1;
  const int S = a.S, W = a.W;

  int pb[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) pb[j] = band.addr(min((n0 + kWarpsN * j) * 8 + gid, band.P - 1), W);
  float acc[MW][NT][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const int n_cb = a.Hd / KC;
  const int mt_all = a.Hd / 16;
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3 - 1) * band.Wp + (tap % 3 - 1);
    for (int cb = 0; cb < n_cb; ++cb, ++chunk) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk landed for every thread; the stage refilled below is free
      ring.template issue<chunk_vecs<MW, KC, BF>()>(chunk + kStages - 1);
      const uint4* frag =
          reinterpret_cast<const uint4*>(ring.base + (chunk % kStages) * ring.chunk_floats);
      const float* s0 = src + (cb * KC + tig) * S + off;
      float part[MW][NT][4];
      if constexpr (BF) {
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks, s0 += 16 * S) {
          uint32_t b[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            b[j][0] = pack_bf16(fmaxf(s0[pb[j]], 0.f), fmaxf(s0[4 * S + pb[j]], 0.f));
            b[j][1] = pack_bf16(fmaxf(s0[8 * S + pb[j]], 0.f), fmaxf(s0[12 * S + pb[j]], 0.f));
          }
          uint4 af[MW];
#pragma unroll
          for (int m = 0; m < MW; ++m) af[m] = frag[(ks * mt_all + m0 + m) * 32 + lane];
#pragma unroll
          for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (ks == 0) mma_bf16_zero(part[m][j], af[m], b[j][0], b[j][1]);
              else mma_bf16(part[m][j], af[m], b[j][0], b[j][1]);
              if (ks == KC / 16 - 1)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
            }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks, s0 += 8 * S) {
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            split_tf32(fmaxf(s0[pb[j]], 0.f), bh[j][0], bl[j][0]);
            split_tf32(fmaxf(s0[4 * S + pb[j]], 0.f), bh[j][1], bl[j][1]);
          }
          uint4 ah[MW], al[MW];
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            ah[m] = frag[((ks * mt_all + m0 + m) * 2 + 0) * 32 + lane];
            al[m] = frag[((ks * mt_all + m0 + m) * 2 + 1) * 32 + lane];
          }
          // part holds the sum over kSpan k-steps: zero-initialised by the
          // first mma of the span, added into acc after the last.
          constexpr int span = kSpan < KC / 8 ? kSpan : KC / 8;
          const bool first = ks % span == 0, last = ks % span == span - 1;
#pragma unroll
          for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j) {  // small terms first
              if (first) mma_tf32_zero(part[m][j], al[m], bh[j][0], bh[j][1]);
              else mma_tf32(part[m][j], al[m], bh[j][0], bh[j][1]);
            }
#pragma unroll
          for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_tf32(part[m][j], ah[m], bl[j][0], bl[j][1]);
#pragma unroll
          for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              mma_tf32(part[m][j], ah[m], bh[j][0], bh[j][1]);
              if (last)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
            }
        }
      }
    }
  }

  // Accumulator e of (m, j): output channel (m0 + m)·16 + gid + 8·(e ≥ 2),
  // band pixel (n0 + 8·j)·8 + 2·tig + (e & 1); -1 marks a pixel past the band.
  int px[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = (n0 + kWarpsN * j) * 8 + 2 * tig + i;
      px[j][i] = p < band.P ? band.addr(p, W) : -1;
    }
#pragma unroll
  for (int m = 0; m < MW; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = (m0 + m) * 16 + gid + ((e >> 1) << 3);
      const float b = __ldg(bias + o);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (px[j][e & 1] < 0) continue;
        const int idx = o * S + px[j][e & 1];
        const float v = acc[m][j][e] + b;
        dst[idx] = accumulate ? dst[idx] + v : v;
      }
    }
  }
}

// Copy the map's halo rows out of the neighbouring CTAs' shared memory.
__device__ void copy_halos(float* map, const Args& a, const Band& band, cg::cluster_group& cluster) {
  const int W = a.W, S = a.S, n = a.Hd * W;
  if (band.rank > 0) {  // top halo ← last row of the band above
    const float* nb = cluster.map_shared_rank(map, band.rank - 1);
    const int rows_up = band.r0 - band_start(band.rank - 1, a.H, a.cluster);
    for (int q = threadIdx.x; q < n; q += kThreads) {
      const int ch = q / W, c = q - ch * W;
      map[ch * S + 1 + c] = nb[ch * S + 1 + rows_up * band.Wp + c];
    }
  }
  if (band.rank < a.cluster - 1) {  // bottom halo ← first row of the band below
    const float* nb = cluster.map_shared_rank(map, band.rank + 1);
    for (int q = threadIdx.x; q < n; q += kThreads) {
      const int ch = q / W, c = q - ch * W;
      map[ch * S + 1 + (band.rows + 1) * band.Wp + c] = nb[ch * S + 1 + band.Wp + c];
    }
  }
}

template <int MW, int NT, int KC, bool BF>
__global__ void __launch_bounds__(kThreads, 1) coupler_stack_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* hmap = reinterpret_cast<float*>(smem4);
  float* tmap = hmap + a.Hd * a.S;
  cg::cluster_group cluster = cg::this_cluster();

  Band band;
  band.rank = (int)cluster.block_rank();
  band.img = blockIdx.x / a.cluster;
  band.r0 = band_start(band.rank, a.H, a.cluster);
  band.rows = band_start(band.rank + 1, a.H, a.cluster) - band.r0;
  band.P = band.rows * a.W;
  band.Wp = a.W + 1;
  const int W = a.W, S = a.S, P = band.P;

  Ring ring;
  ring.base = tmap + a.Hd * a.S;
  ring.src = a.frags;
  ring.chunk_floats = BF ? KC * a.Hd / 2 : KC * a.Hd * 2;  // bf16: 2 bytes a weight, no lo part
  ring.total = a.num_blocks * 2 * 9 * (a.Hd / KC);
  for (int c = 0; c < kStages - 1; ++c) ring.template issue<chunk_vecs<MW, KC, BF>()>(c);

  // Both maps to zero: the pad columns, and the halo rows at the image border.
  for (int q = threadIdx.x; q < a.Hd * S / 2; q += kThreads) smem4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // Stage the input band with its halo rows in t's place.
  const float* xb = a.x + (size_t)band.img * a.C_in * a.H * W;
  const int n_x = a.C_in * (band.rows + 2) * W;
  for (int q = threadIdx.x; q < n_x; q += kThreads) {
    const int ch = q / ((band.rows + 2) * W);
    const int rem = q - ch * (band.rows + 2) * W;
    const int rr = rem / W, c = rem - rr * W;
    const int r = band.r0 - 1 + rr;
    if (r >= 0 && r < a.H) {
      const float v = __ldg(xb + ((size_t)ch * a.H + r) * W + c);
      tmap[ch * S + 1 + rr * band.Wp + c] = BF ? round_bf16(v) : v;
    }
  }
  __syncthreads();

  // conv_in on the fp32 pipes: a thread owns 8 output channels of a pixel.
  // In the bf16 variant the input (above) and w_in (by the wrapper) are
  // bf16-rounded, so each product is exact.
  const float* w_in = a.small;
  for (int item = threadIdx.x; item < (a.Hd / 8) * P; item += kThreads) {
    const int og = item / P, p = item - og * P;
    const int base = band.addr(p, W);
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    for (int i = 0; i < a.C_in; ++i) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = tmap[i * S + base + (tap / 3 - 1) * band.Wp + (tap % 3 - 1)];
        const float* w = w_in + (i * 9 + tap) * a.Hd + og * 8;
        const float4 wa = __ldg(reinterpret_cast<const float4*>(w));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(w + 4));
        acc[0] = fmaf(wa.x, v, acc[0]);
        acc[1] = fmaf(wa.y, v, acc[1]);
        acc[2] = fmaf(wa.z, v, acc[2]);
        acc[3] = fmaf(wa.w, v, acc[3]);
        acc[4] = fmaf(wb.x, v, acc[4]);
        acc[5] = fmaf(wb.y, v, acc[5]);
        acc[6] = fmaf(wb.z, v, acc[6]);
        acc[7] = fmaf(wb.w, v, acc[7]);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) hmap[(og * 8 + q) * S + base] = acc[q];
  }

  const float* biases = w_in + a.C_in * 9 * a.Hd;
  int chunk = 0;
  if (a.num_blocks > 0) {
    cluster.sync();
    copy_halos(hmap, a, band, cluster);
  }
  __syncthreads();
  for (int k = 0; k < a.num_blocks; ++k) {
    conv3x3_mma<MW, NT, KC, BF>(hmap, tmap, false, biases + (2 * k) * a.Hd, a, band, ring, chunk);
    cluster.sync();
    copy_halos(tmap, a, band, cluster);
    __syncthreads();
    conv3x3_mma<MW, NT, KC, BF>(tmap, hmap, true, biases + (2 * k + 1) * a.Hd, a, band, ring, chunk);
    // After this barrier no CTA of the cluster reads another's t again, and
    // h's halos are read only if another conv follows. So a CTA may leave
    // after the last one.
    cluster.sync();
    if (k + 1 < a.num_blocks) copy_halos(hmap, a, band, cluster);
    __syncthreads();
  }

  // relu → 1×1 conv + b → head_w·tanh + head_b, on the band's own pixels.
  const float* w_out = biases + 2 * a.num_blocks * a.Hd;
  const float* b_out = w_out + a.Hd * a.C_out;
  const float* head_w = b_out + a.C_out;
  const float* head_b = head_w + a.C_out;
  float* ob = a.out + (size_t)band.img * a.C_out * a.H * W + (size_t)band.r0 * W;
  for (int q = threadIdx.x; q < a.C_out * P; q += kThreads) {
    const int o = q / P, p = q - o * P;
    const int base = band.addr(p, W);
    float acc = 0.f;
    for (int i = 0; i < a.Hd; ++i) acc = fmaf(__ldg(w_out + i * a.C_out + o), fmaxf(hmap[i * S + base], 0.f), acc);
    ob[(size_t)o * a.H * W + p] = __ldg(head_w + o) * tanhf(acc + __ldg(b_out + o)) + __ldg(head_b + o);
  }
}

// The launch plan is shared by both arithmetics, so a bf16 launch reserves
// the TF32 ring's room and uses a quarter of each stage.
int smem_bytes(int Hd, int S, int kc) { return 4 * (2 * Hd * S + kStages * kc * Hd * 2); }

template <int MW, int NT, int KC, bool BF>
cudaError_t prepare(int cluster, int smem) {
  cudaError_t e = cudaFuncSetAttribute(coupler_stack_kernel<MW, NT, KC, BF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(coupler_stack_kernel<MW, NT, KC, BF>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <int MW, int NT, int KC, bool BF>
cudaError_t launch(const Args& a, int B, int smem, cudaStream_t stream) {
  cudaError_t e = prepare<MW, NT, KC, BF>(a.cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, coupler_stack_kernel<MW, NT, KC, BF>, a);
}

template <int MW, int NT, int KC>
cudaError_t max_clusters(int cluster, int smem, int* n) {
  cudaError_t e = prepare<MW, NT, KC, false>(cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * 64), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, coupler_stack_kernel<MW, NT, KC, false>, &cfg);
}

// The instance for a padded hidden width (32 or 64), n-tiles a warp and
// chunk depth.
#define CMF_DISPATCH(Hd, nt, kc, CALL)                                       \
  switch (((Hd) / 32) * 100 + (nt) * 10 + (kc) / 16) {                       \
    case 112: return CALL(1, 1, 32);                                         \
    case 122: return CALL(1, 2, 32);                                         \
    case 132: return CALL(1, 3, 32);                                         \
    case 142: return CALL(1, 4, 32);                                         \
    case 212: return CALL(2, 1, 32);                                         \
    case 222: return CALL(2, 2, 32);                                         \
    case 232: return CALL(2, 3, 32);                                         \
    case 242: return CALL(2, 4, 32);                                         \
    case 241: return CALL(2, 4, 16);                                         \
    default: return cudaErrorInvalidValue;                                   \
  }

int tiles_per_warp(int H, int W, int cluster) {
  const int rows = (H + cluster - 1) / cluster;
  return ((rows * W + 7) / 8 + kWarpsN - 1) / kWarpsN;
}

template <bool BF>
cudaError_t launch_any(const Args& a, int B, int smem, cudaStream_t stream) {
#define CMF_LAUNCH(MW, NT, KC) launch<MW, NT, KC, BF>(a, B, smem, stream)
  CMF_DISPATCH(a.Hd, tiles_per_warp(a.H, a.W, a.cluster), a.kc, CMF_LAUNCH)
#undef CMF_LAUNCH
}

cudaError_t max_clusters_any(int Hd, int nt, int kc, int cluster, int smem, int* n) {
#define CMF_OCCUPANCY(MW, NT, KC) max_clusters<MW, NT, KC>(cluster, smem, n)
  CMF_DISPATCH(Hd, nt, kc, CMF_OCCUPANCY)
#undef CMF_OCCUPANCY
}

// The launch plan the wrapper chose (ops/coupler_stack.py::plan_launch),
// checked again here: a plan the kernel cannot run is refused, not launched.
bool plan_ok(int C_in, int H, int W, int Hd, int cluster, int S, int kc) {
  if (H < 1 || W < 1 || C_in < 1 || (Hd != 32 && Hd != 64) || C_in > Hd) return false;
  if (cluster < 1 || cluster > kMaxCluster || cluster > H) return false;
  if (kc != 32 && !(kc == 16 && Hd == 64 && tiles_per_warp(H, W, cluster) == 4)) return false;
  const int rows = (H + cluster - 1) / cluster;
  if (rows * W > kMaxPixels) return false;
  if (S % 8 != 0 || S < (rows + 2) * (W + 1) + 1) return false;
  return smem_bytes(Hd, S, kc) <= kSmemLimit;
}

template <bool BF>
int forward(const void* x, const void* frags, const void* small, void* out, int B, int C_in, int H, int W,
            int Hd, int num_blocks, int C_out, int cluster, int S, int kc, void* stream) {
  if (B < 1 || num_blocks < 0 || C_out < 1 || !plan_ok(C_in, H, W, Hd, cluster, S, kc))
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)x, (const float*)frags, (const float*)small, (float*)out,
         C_in, H, W, Hd, num_blocks, C_out, cluster, S, kc};
  const cudaError_t e = launch_any<BF>(a, B, smem_bytes(Hd, S, kc), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors: x (B, C_in, H, W) fp32; frags and small packed by
// ops/coupler_stack.py::pack_weights (frags fp32 hi/lo TF32 fragments, or
// bf16 fragments for the bf16 entry; small fp32); out (B, C_out, H, W) fp32.
// Hd is the hidden width padded to 32 or 64; cluster, S (map stride in
// floats) and kc (input channels per weight chunk) are the launch plan, the
// same for both arithmetics. The kernel runs on `stream`; the return value
// is the launch's error, then cudaGetLastError() (0 = launched).
extern "C" int cmf_coupler_stack_fwd(const void* x, const void* frags, const void* small, void* out,
                                     int B, int C_in, int H, int W, int Hd, int num_blocks,
                                     int C_out, int cluster, int S, int kc, void* stream) {
  return forward<false>(x, frags, small, out, B, C_in, H, W, Hd, num_blocks, C_out, cluster, S, kc, stream);
}

// The bf16=True arithmetic, with the same arguments.
extern "C" int cmf_coupler_stack_fwd_bf16(const void* x, const void* frags, const void* small, void* out,
                                          int B, int C_in, int H, int W, int Hd, int num_blocks,
                                          int C_out, int cluster, int S, int kc, void* stream) {
  return forward<true>(x, frags, small, out, B, C_in, H, W, Hd, num_blocks, C_out, cluster, S, kc, stream);
}

// How many clusters of this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), for the smoke run's report. Returns the
// CUDA error, 0 on success.
extern "C" int cmf_coupler_stack_max_clusters(int H, int W, int Hd, int cluster, int S, int kc, int* n) {
  if (!plan_ok(1, H, W, Hd, cluster, S, kc)) return (int)cudaErrorInvalidValue;
  return (int)max_clusters_any(Hd, tiles_per_warp(H, W, cluster), kc, cluster, smem_bytes(Hd, S, kc), n);
}
