// Fused ResNet-coupler forward for the multiscale image couplings, written
// for Hopper (sm_90a).
//
// Replaces the Pallas/TPU kernel cmf_tpu/ops/pallas/coupler_stack.py::_kernel
// (:124, launched by _call :169 through fused_resnet_coupler :198), in both
// its arithmetics, each a kernel of its own:
// - coupler_stack_kernel (cmf_coupler_stack_fwd), bf16=False: fp32 inputs,
//   weights, biases, residual stream, outputs and sums.
// - coupler_stack_bf16_kernel (cmf_coupler_stack_fwd_bf16), bf16=True
//   (:83-147): every 3×3 conv, conv_in included, multiplies the bf16-rounded
//   shifted map by the bf16-rounded weight and sums in fp32; the residual
//   stream, the biases, the 1×1 conv and the head stay fp32.
//
// Per image b, with hidden width Hd and K residual blocks, both compute
// ResNet.apply of the batchnorm-free coupler net (cmf_tpu/nets/core.py:271):
//   h   = conv3x3(x)                                   (bias-free conv_in)
//   h  += conv3x3(relu(conv3x3(relu(h)) + b1)) + b2    (K times)
//   out = head_w · tanh(conv1x1(relu(h)) + b_out) + head_b
// Every 3×3 conv is a cross-correlation with zero padding at the image
// border, as the TPU kernel's tap masks give (coupler_stack.py:70-80).
//
// Both cut an image the same way. One image is one thread-block cluster of
// N CTAs (N ≤ 16). CTA r owns image rows [r·H/N, (r+1)·H/N) across all
// channels, and its band of every map lives in shared memory for all 17
// convs: no device-memory scratch. A map holds the band's rows of W+1 (one
// zero column shared between neighbouring rows), a halo row above and below
// and a leading zero, so a 3×3 tap is a constant offset and no masks are
// needed. conv_in and the 1×1 conv with its tanh head are small and run on
// the fp32 pipes.
//
// == The fp32 kernel ==
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
// - The residual stream h and the temporary t are [Hd][S] fp32 maps.
//   S ≡ 8 or 24 (mod 32), so the 4 channels × 8 pixels of a B fragment load
//   fall in 32 different banks.
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
//   split into hi/lo TF32 by the wrapper, packed in mma fragment order (one
//   16-byte load per lane per m-tile and k-step), and stream through a
//   3-stage cp.async ring in chunks of one tap × 16 or 32 input channels,
//   while the tensor cores work on the chunk before. The ring runs across
//   conv boundaries.
// - The tensor cores truncate as they accumulate, so the mmas of each span
//   of 4 k-steps (32 input channels of a tap) sum into a fresh partial that
//   the fp32 pipes add into the running sum (conv3x3_mma).
//
// == The bf16 kernel ==
//
// Bound on an H100 SXM: operations. The same 926 MFLOP an image, the Hd×Hd
// convs once at 989 TFLOP/s in bf16: 0.234 ms at B=250. Its design takes
// the card's strengths: wgmma, bulk copies, mbarriers.
// - Maps. The two conv inputs live in shared memory as bf16, relu'd and
//   rounded once, when the conv that produces them writes its epilogue
//   (round∘relu = relu∘round, so the arithmetic is the TPU kernel's): H
//   holds relu(h) for conv1, T holds relu(t) for conv2. A map is [channel
//   group of 8][map pixel][8 channels], 16 B a pixel and group, over
//   map_px pixels; Cm channels, the hidden width padded to 16. The fp32
//   residual h stays exact in shared memory, in accumulator order: each
//   thread reads and writes only its own elements, 16 B at a time.
// - The product. out[64 × P] = W[64 × 9·64] · map[9·64 × P], M the output
//   channels and K (tap, input channel) padded to 64 with zero weights, N
//   the band's padded pixels. Two warpgroups each own a fixed run of N ≤
//   256 of them and issue wgmma.mma_async m64nNk16 bf16 with fp32 sums,
//   both operands read from shared memory through descriptors in the
//   no-swizzle K-major layout (conv_gmma). A 3×3 tap is a constant pixel
//   offset, so its B descriptor is tap (0, 0)'s with the start moved by
//   16·(dy·(W+1) + dx) bytes: no im2col, no masks, no per-lane loads or
//   conversions in the main loop. 4 k-steps a tap (past Cm channels B reads
//   a zero block), 36 a conv in one straight line, all into one fp32
//   accumulator.
// - Weights. The wrapper packs each tap as the A descriptor reads it, a
//   64 × 64 bf16 tile (8 KB). One thread streams the taps with
//   cp.async.bulk into a ring of up to 9 stages, each completed on its full
//   mbarrier; every warp frees a stage with an arrive on its empty mbarrier
//   once its wgmmas on it are done, and the thread refills a stage 3 taps
//   after it was freed, while the tensor cores work, so it seldom waits. No
//   __syncthreads() in the conv loop; the ring runs across conv boundaries.
//   No warp is set aside for the copies: 8 warps, 2 on each SM
//   sub-partition, may hold up to 255 registers a thread (9 would get 168).
// - Epilogue. The bias from two registers a thread; h updated in place; the
//   bf16 relu map written with stmatrix for the band's own pixels only
//   (never a pad column or a pixel past the band: they are the conv's zero
//   padding); then the band's first and last rows copied into the
//   neighbouring CTAs' halo rows over distributed shared memory, 16 B a
//   store, and one cluster barrier a conv, with a generic-to-async proxy
//   fence on each side, before the next conv's wgmmas read the maps.
// - conv_in (on the bf16-rounded input, staged in T's place) and the head
//   stay on the fp32 pipes, each thread on its own elements.

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
  const float* frags;  // hi/lo TF32 fragments of the 2K Hd×Hd convs, in stream order
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
// hi/lo floats.
template <int MW, int KC>
__host__ __device__ constexpr int chunk_vecs() {
  return KC * 32 * MW * 2 / 4;
}

// The weight stream: chunk c of `total` goes to ring stage c % kStages.
struct Ring {
  float* base;
  const float* src;
  int chunk_floats, total;
  // kVec 16-byte copies a chunk (chunk_floats == 4 · kVec), a whole number
  // a thread.
  template <int kVec>
  __device__ __forceinline__ void issue(int c) const {
    static_assert(kVec % kThreads == 0, "a chunk splits evenly over the threads");
    if (c < total) {
      const float4* g = reinterpret_cast<const float4*>(src + (size_t)c * chunk_floats);
      float4* s = reinterpret_cast<float4*>(base + (c % kStages) * chunk_floats);
#pragma unroll
      for (int q = 0; q < kVec / kThreads; ++q) cp_async16(s + q * kThreads + threadIdx.x, g + q * kThreads + threadIdx.x);
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  }
};

// dst[o][p] (+)= bias[o] + Σ_{tap,i} W[o][tap,i] · relu(src[i][p + tap]) over
// the band on the tensor cores in 3×TF32. Consumes 9·Hd/KC ring chunks.
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
// into the same partial are MW·NT issues apart.
template <int MW, int NT, int KC>
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
      ring.template issue<chunk_vecs<MW, KC>()>(chunk + kStages - 1);
      const uint4* frag =
          reinterpret_cast<const uint4*>(ring.base + (chunk % kStages) * ring.chunk_floats);
      const float* s0 = src + (cb * KC + tig) * S + off;
      float part[MW][NT][4];
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

template <int MW, int NT, int KC>
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
  ring.chunk_floats = KC * a.Hd * 2;
  ring.total = a.num_blocks * 2 * 9 * (a.Hd / KC);
  for (int c = 0; c < kStages - 1; ++c) ring.template issue<chunk_vecs<MW, KC>()>(c);

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
      tmap[ch * S + 1 + rr * band.Wp + c] = v;
    }
  }
  __syncthreads();

  // conv_in on the fp32 pipes: a thread owns 8 output channels of a pixel.
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
    conv3x3_mma<MW, NT, KC>(hmap, tmap, false, biases + (2 * k) * a.Hd, a, band, ring, chunk);
    cluster.sync();
    copy_halos(tmap, a, band, cluster);
    __syncthreads();
    conv3x3_mma<MW, NT, KC>(tmap, hmap, true, biases + (2 * k + 1) * a.Hd, a, band, ring, chunk);
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

int smem_bytes(int Hd, int S, int kc) { return 4 * (2 * Hd * S + kStages * kc * Hd * 2); }

// A kernel of either arithmetic, one cluster of `cluster` CTAs an image.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int cluster, int smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <typename Kernel, typename A>
cudaError_t launch(Kernel kernel, const A& a, int threads, int B, int smem, cudaStream_t stream) {
  cudaError_t e = prepare(kernel, a.cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.cluster), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename Kernel>
cudaError_t max_clusters(Kernel kernel, int threads, int cluster, int smem, int* n) {
  cudaError_t e = prepare(kernel, cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * 64), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
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

cudaError_t launch_any(const Args& a, int B, int smem, cudaStream_t stream) {
#define CMF_LAUNCH(MW, NT, KC) launch(coupler_stack_kernel<MW, NT, KC>, a, kThreads, B, smem, stream)
  CMF_DISPATCH(a.Hd, tiles_per_warp(a.H, a.W, a.cluster), a.kc, CMF_LAUNCH)
#undef CMF_LAUNCH
}

cudaError_t max_clusters_any(int Hd, int nt, int kc, int cluster, int smem, int* n) {
#define CMF_OCCUPANCY(MW, NT, KC) max_clusters(coupler_stack_kernel<MW, NT, KC>, kThreads, cluster, smem, n)
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

int forward(const void* x, const void* frags, const void* small, void* out, int B, int C_in, int H, int W,
            int Hd, int num_blocks, int C_out, int cluster, int S, int kc, void* stream) {
  if (B < 1 || num_blocks < 0 || C_out < 1 || !plan_ok(C_in, H, W, Hd, cluster, S, kc))
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)x, (const float*)frags, (const float*)small, (float*)out,
         C_in, H, W, Hd, num_blocks, C_out, cluster, S, kc};
  const cudaError_t e = launch_any(a, B, smem_bytes(Hd, S, kc), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The bf16 kernel (bf16=True). See the header for its design.
namespace bf {

constexpr int kWarpgroups = 2;                          // warpgroups on the tensor cores
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kMaxStages = 9;                          // weight ring stages: a conv's 9 taps
constexpr int kRefillLag = 3;                          // a tap refills the stage of the tap 3 before
constexpr int kZeroOffset = 256;                       // after full[9] and empty[9] mbarriers
constexpr int kTrashOffset = 512;                      // after a 256-byte zero block
constexpr int kHeadBytes = 640;                        // mbarriers, zero block, trash slot
constexpr int kStageBytes = 128 * 64;                  // a tap's 64 × 64 bf16 weight tile

struct Args {
  const float* x;              // (B, C_in, H, W)
  const __nv_bfloat16* wts;    // the 2K Hd×Hd convs, per conv and tap a 64 × 64 A tile (pack_weights)
  const float* small;          // as the fp32 kernel's
  float* out;                  // (B, C_out, H, W)
  int C_in, H, W, Hd, Cm, num_blocks, C_out, cluster, map_px, stages;
};

// D[64 × N] (+)= A[64 × 16] · B[16 × N], bf16 operands from shared memory
// through descriptors (both K-major), fp32 sums in d; acc = 0 starts a fresh
// sum. One specialisation a width N of the instance set, each made by
// CMF_GMMA from one asm template: d's R = N/2 registers are operands 0 to
// R-1 (CMF_REGS<R> names them in the string, CMF_OUTS<R> binds them), then
// a, b and acc.
template <int N>
struct Gmma;

#define CMF_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CMF_REGS16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define CMF_OUTS16 CMF_D4(0), CMF_D4(4), CMF_D4(8), CMF_D4(12)
#define CMF_REGS32 CMF_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define CMF_OUTS32 CMF_OUTS16, CMF_D4(16), CMF_D4(20), CMF_D4(24), CMF_D4(28)
#define CMF_REGS52 CMF_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
#define CMF_OUTS52 CMF_OUTS32, CMF_D4(32), CMF_D4(36), CMF_D4(40), CMF_D4(44), CMF_D4(48)
#define CMF_REGS56 CMF_REGS52 ", %52, %53, %54, %55"
#define CMF_OUTS56 CMF_OUTS52, CMF_D4(52)
#define CMF_REGS68 CMF_REGS56 ", %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67"
#define CMF_OUTS68 CMF_OUTS56, CMF_D4(56), CMF_D4(60), CMF_D4(64)
#define CMF_REGS80 CMF_REGS68 ", %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define CMF_OUTS80 CMF_OUTS68, CMF_D4(68), CMF_D4(72), CMF_D4(76)
#define CMF_REGS92 CMF_REGS80 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91"
#define CMF_OUTS92 CMF_OUTS80, CMF_D4(80), CMF_D4(84), CMF_D4(88)
#define CMF_REGS104 CMF_REGS92 ", %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103"
#define CMF_OUTS104 CMF_OUTS92, CMF_D4(92), CMF_D4(96), CMF_D4(100)
#define CMF_REGS116 CMF_REGS104 ", %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115"
#define CMF_OUTS116 CMF_OUTS104, CMF_D4(104), CMF_D4(108), CMF_D4(112)
#define CMF_REGS128 CMF_REGS116 ", %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define CMF_OUTS128 CMF_OUTS116, CMF_D4(116), CMF_D4(120), CMF_D4(124)
#define CMF_GMMA(N, R, A, B, ACC)                                                             \
  template <>                                                                                 \
  struct Gmma<N> {                                                                            \
    static __device__ __forceinline__ void mma(float (&d)[R], uint64_t a, uint64_t b, uint32_t acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ACC ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" CMF_REGS##R       \
                   "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                                    \
                   : CMF_OUTS##R                                                              \
                   : "l"(a), "l"(b), "r"(acc));                                               \
    }                                                                                         \
  };
CMF_GMMA(32, 16, 16, 17, 18)
CMF_GMMA(64, 32, 32, 33, 34)
CMF_GMMA(104, 52, 52, 53, 54)
CMF_GMMA(112, 56, 56, 57, 58)
CMF_GMMA(136, 68, 68, 69, 70)
CMF_GMMA(160, 80, 80, 81, 82)
CMF_GMMA(184, 92, 92, 93, 94)
CMF_GMMA(208, 104, 104, 105, 106)
CMF_GMMA(232, 116, 116, 117, 118)
CMF_GMMA(256, 128, 128, 129, 130)
#undef CMF_GMMA
#undef CMF_D4

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// A wgmma matrix descriptor for the no-swizzle (interleave) layout: start
// address, leading byte offset (LBO: between the core matrices adjacent in
// K) and stride byte offset (SBO: between those adjacent in M or N), each in
// 16-byte units in 14 bits; base offset 0 and layout type 0 (bits 49-51,
// 62-63). A core matrix is 8 rows of 16 contiguous bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keeps the compiler from moving reads of the accumulator registers across
// the wait for the wgmmas that write them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One-dimensional bulk copy (TMA) of `bytes` from device memory into this
// CTA's shared memory, completed on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// The cluster barrier in its two halves: every thread of the cluster
// arrives, then waits for the others.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// Orders this thread's generic-proxy shared-memory stores with the async
// proxy (the wgmmas that read the maps).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// Where a thread's accumulator elements lie. Element 4j + e of a
// warpgroup's m64nN accumulator is output channel 16·warp + lane/4 + 8·(e/2)
// at band pixel wg·N + 8j + 2·(lane%4) + e%2, a pixel counted over the band's
// padded rows of W+1 (pixel r·(W+1) + c is row r, column c; c = W is the pad
// column).
struct Frag {
  int wg, warp, lane, rank;
  int rows, rows_up, W, Wp, Cm, map_px, cluster;

  __device__ bool live() const { return warp * 16 < Cm; }  // its channels are real
  __device__ int channel(int hi) const { return warp * 16 + (lane >> 2) + 8 * hi; }
  // Float index of elements 4j .. 4j+3 in h's shared copy, in accumulator
  // order: each thread reads and writes only its own elements, 16 bytes a j,
  // 512 consecutive bytes a warp.
  template <int N>
  __device__ int h_index(int j) const {
    return ((wg * (N / 8) + j) * (2 * Cm) + warp * 32 + lane) * 4;
  }
};

// Visits the thread's elements that lie on the band's own pixels, in
// accumulator order: f(j, e, row, col). A pad column or a pixel past the
// band (row ≥ rows) is never visited.
template <int N, typename F>
__device__ __forceinline__ void for_band_pixels(const Frag& g, F&& f) {
  const int n0 = g.wg * N + 2 * (g.lane & 3);
  int r = n0 / g.Wp, c = n0 - r * g.Wp;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int rr = r, cc = c + half;
      if (cc == g.Wp) cc = 0, ++rr;
      if (rr < g.rows && cc < g.W) {
        f(j, half, rr, cc);
        f(j, half + 2, rr, cc);
      }
    }
    c += 8;
    while (c >= g.Wp) c -= g.Wp, ++r;
  }
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Writes round(relu(v)) (= relu(round(v))) to the bf16 map of the band's own
// pixels with stmatrix: the accumulator's 8 × 8 blocks (8 channels × 8
// pixels) are the fragments it takes, and .trans stores each pixel's 8
// channels as the 16 contiguous bytes of the map's layout. Map element
// (channel ch, map pixel q) sits at ((ch/8)·map_px + q)·8 + ch%8; band pixel
// (row, col) is map pixel 1 + (row+1)·(W+1) + col. Lane l gives the address
// of pixel l%8 of block l/8; a pad column or a pixel past the band goes to
// `trash`, so it stays the conv's zero padding.
template <int N>
__device__ __forceinline__ void store_map(const float (&v)[N / 2], uint32_t map, uint32_t trash, const Frag& g) {
  if (!g.live()) return;
  // Block b = l/8 of an instruction is (j + b/2, hi = b%2); its pixel l%8.
  const int blk = g.lane >> 3;
  const uint32_t group = map + (2 * g.warp + (blk & 1)) * g.map_px * 16;
  const int n0 = g.wg * N + 8 * (blk >> 1) + (g.lane & 7);
  int r = n0 / g.Wp, c = n0 - r * g.Wp;
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    const uint32_t addr = r < g.rows && c < g.W ? group + (1 + (r + 1) * g.Wp + c) * 16 : trash;
    if (j + 1 < N / 8) {
      asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(addr), "r"(relu_bf16x2(v[4 * j], v[4 * j + 1])),
                   "r"(relu_bf16x2(v[4 * j + 2], v[4 * j + 3])),
                   "r"(relu_bf16x2(v[4 * j + 4], v[4 * j + 5])),
                   "r"(relu_bf16x2(v[4 * j + 6], v[4 * j + 7]))
                   : "memory");
    } else {  // an odd block count: the last j alone (lanes 0-15 give its addresses)
      asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
                   ::"r"(addr), "r"(relu_bf16x2(v[4 * j], v[4 * j + 1])),
                   "r"(relu_bf16x2(v[4 * j + 2], v[4 * j + 3]))
                   : "memory");
    }
    c += 16;
    while (c >= g.Wp) c -= g.Wp, ++r;
  }
}

// Copies the band's first and last rows of a map into the halo rows of the
// neighbouring CTAs' copy of it over distributed shared memory, 16 bytes
// (a pixel's 8 channels) a store; after every warpgroup wrote its part.
__device__ __forceinline__ void push_halos(__nv_bfloat16* map, const Frag& g, cg::cluster_group& cluster) {
  const int per_dir = (g.Cm / 8) * g.W;
  const uint4* own = reinterpret_cast<const uint4*>(map);
  uint4* up = g.rank > 0 ? reinterpret_cast<uint4*>(cluster.map_shared_rank(map, g.rank - 1)) : nullptr;
  uint4* down = g.rank < g.cluster - 1 ? reinterpret_cast<uint4*>(cluster.map_shared_rank(map, g.rank + 1)) : nullptr;
  for (int q = threadIdx.x; q < 2 * per_dir; q += kThreads) {
    const bool to_down = q >= per_dir;
    const int item = to_down ? q - per_dir : q;
    const int grp = item / g.W, col = item - grp * g.W;
    const int base = grp * g.map_px + 1 + col;
    if (!to_down && up)  // row 0 → the bottom halo row of the band above
      up[base + (g.rows_up + 1) * g.Wp] = own[base + g.Wp];
    if (to_down && down)  // the last row → the top halo row of the band below
      down[base] = own[base + g.rows * g.Wp];
  }
}

// The weight ring: chunk c (conv c/9, tap c%9, a 64 × 64 bf16 tile) goes to
// stage c % stages, a bulk copy completed on the stage's full mbarrier. One
// thread issues them: the first `stages` before conv_in, then chunk c + stages
// - lag at tap c, into the stage that chunk c - lag held, once every warp has
// arrived at its empty mbarrier (lag taps back, so the thread seldom waits).
struct Ring {
  uint32_t base, bars;
  const __nv_bfloat16* src;
  int stages, total, lag;

  __device__ void issue(int c) const {
    const int s = c % stages;
    mbar_expect_tx(bars + 8 * s, kStageBytes);
    bulk_copy(base + s * kStageBytes, src + (size_t)c * (kStageBytes / 2), kStageBytes, bars + 8 * s);
  }
  // At tap c (thread 0 only).
  __device__ void refill(int c) const {
    const int done = c - lag, next = done + stages;
    if (done < 0 || next >= total) return;
    mbar_wait(bars + 8 * (kMaxStages + done % stages), (done / stages) & 1);
    issue(next);
  }
};

// acc = Σ over 9 taps and 4 k-steps of A(tap, k-step) · B(tap, k-step): the
// Hd×Hd 3×3 conv of the warpgroup's N pixels on the bf16 map at `map`,
// before its bias. Consumes 9 ring chunks, from chunk `chunk` on.
//
// A: a ring stage holds one tap's weights as [channel group][64 outputs][8
// channels], 64 channels (zero past the hidden width), so a k-step of 16
// channels is two core matrices along K 1024 B apart (LBO) and 8 along M at
// 128 B (SBO). B: the map is [channel group][pixel][8 channels], so a
// k-step is two channel groups map_px·16 B apart (LBO) and N/8 core matrices
// of 8 pixels at 128 B (SBO); tap (dy, dx) moves the start by
// 16·(dy·(W+1) + dx) bytes. A k-step past the map's Cm channels reads B from
// a 256-byte zero block (SBO 0: every core matrix the same), so the 4
// k-steps are a compile-time count and the taps one straight line of 36
// wgmmas, as the tensor cores need to pipeline them.
template <int N>
__device__ __forceinline__ void conv_gmma(float (&acc)[N / 2], uint32_t map, const Ring& ring, uint32_t zero,
                                          const Frag& g, int& chunk) {
  const int stages = ring.stages;
  const uint32_t bars = ring.bars;
  const uint32_t b_lbo = g.map_px * 16;
  const uint32_t first = map + (1 + g.Wp + g.wg * N) * 16;  // the warpgroup's pixel 0, tap (0, 0)
  const uint64_t b_zero = gmma_desc(zero, 128, 0);
  const int ksteps = g.Cm / 16;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap, ++chunk) {
    const int s = chunk % stages;
    const uint64_t a = gmma_desc(ring.base + s * kStageBytes, 1024, 128);
    const uint64_t b = gmma_desc(first + ((tap / 3 - 1) * g.Wp + (tap % 3 - 1)) * 16, b_lbo, 128);
    uint64_t bk[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) bk[ks] = ks < ksteps ? b + ks * 2 * g.map_px : b_zero;
    mbar_wait(bars + 8 * s, (chunk / stages) & 1);
    gmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Gmma<N>::mma(acc, a + ks * (2048 >> 4), bk[ks], tap | ks);
    gmma_commit();
    if (threadIdx.x == 0) ring.refill(chunk);  // while the tensor cores work
    __syncwarp();
    gmma_wait<1>();  // the previous tap's wgmmas are done with their stage
    if (tap > 0 && g.lane == 0) mbar_arrive(bars + 8 * (kMaxStages + (chunk - 1) % stages));
  }
  gmma_wait<0>();
  fence_regs(acc);
  if (g.lane == 0) mbar_arrive(bars + 8 * (kMaxStages + (chunk - 1) % stages));
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1) coupler_stack_bf16_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / a.cluster;
  const int r0 = band_start(rank, a.H, a.cluster);
  const int rows = band_start(rank + 1, a.H, a.cluster) - r0;
  const int W = a.W, Wp = W + 1, Cm = a.Cm, MP = a.map_px;
  const int n_convs = 2 * a.num_blocks;

  // Shared memory: mbarriers (full[s] at 8s, empty[s] at 8·(9+s)), a
  // 256-byte zero block and a 16-byte trash slot; the weight ring; the bf16
  // maps H (relu h) and T (relu t, and before conv 0 the bf16 input with its
  // halos, [C_in][map_px]); h in fp32.
  const uint32_t bars = smem_u32(smem);
  const uint32_t zero = bars + kZeroOffset, trash = bars + kTrashOffset;
  __nv_bfloat16* hmap = reinterpret_cast<__nv_bfloat16*>(smem + kHeadBytes + a.stages * kStageBytes);
  __nv_bfloat16* tmap = hmap + Cm * MP;
  const int t_elems = max(Cm, a.C_in) * MP;
  float* hreg = reinterpret_cast<float*>(tmap + t_elems);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                           // the filling thread's expect_tx
      mbar_init(bars + 8 * (kMaxStages + s), kThreads / 32);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < (kTrashOffset - kZeroOffset) / 16)
    reinterpret_cast<uint4*>(smem + kZeroOffset)[threadIdx.x] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  Ring ring{bars + kHeadBytes, bars, a.wts, a.stages, n_convs * 9, min(kRefillLag, a.stages - 1)};
  if (threadIdx.x == 0)
    for (int c = 0; c < min(a.stages, ring.total); ++c) ring.issue(c);

  Frag g;
  g.wg = threadIdx.x >> 7;
  g.warp = (threadIdx.x >> 5) & 3;
  g.lane = threadIdx.x & 31;
  g.rank = rank;
  g.rows = rows;
  g.rows_up = rank > 0 ? r0 - band_start(rank - 1, a.H, a.cluster) : 0;
  g.W = W;
  g.Wp = Wp;
  g.Cm = Cm;
  g.map_px = MP;
  g.cluster = a.cluster;

  // Both maps to zero: the pad columns, the halo rows at the image border
  // and the pixels past the band are the convs' zero padding and are never
  // written again. Then no CTA writes into another before all have zeroed.
  const int zero16 = (Cm * MP + t_elems) * 2 / 16;
  for (int q = threadIdx.x; q < zero16; q += kThreads)
    reinterpret_cast<uint4*>(hmap)[q] = make_uint4(0, 0, 0, 0);
  cluster_arrive();
  cluster_wait();

  // Stage the input band with its halo rows in T's place, rounded to bf16.
  __nv_bfloat16* xs = tmap;
  const float* xb = a.x + (size_t)img * a.C_in * a.H * W;
  const int n_x = a.C_in * (rows + 2) * W;
  for (int q = threadIdx.x; q < n_x; q += kThreads) {
    const int ch = q / ((rows + 2) * W);
    const int rem = q - ch * (rows + 2) * W;
    const int rr = rem / W, c = rem - rr * W;
    const int r = r0 - 1 + rr;
    if (r >= 0 && r < a.H)
      xs[ch * MP + 1 + rr * Wp + c] = __float2bfloat16_rn(__ldg(xb + ((size_t)ch * a.H + r) * W + c));
  }
  __syncthreads();

  // conv_in on the fp32 pipes, each thread on its own accumulator elements:
  // bf16-rounded input and weights (rounded by the wrapper), exact products.
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const float* w_in = a.small;
  if (g.live()) {
    for_band_pixels<N>(g, [&](int j, int e, int row, int col) {
      const int ch = g.channel(e >> 1);
      const int q = 1 + (row + 1) * Wp + col;
      float s = 0.f;
      for (int i = 0; i < a.C_in; ++i) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          s = fmaf(__ldg(w_in + (i * 9 + tap) * a.Hd + ch),
                   __bfloat162float(xs[i * MP + q + (tap / 3 - 1) * Wp + (tap % 3 - 1)]), s);
      }
      acc[4 * j + e] = s;
    });
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float4*>(hreg + g.h_index<N>(j)) =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();  // the staged input is read: T back to zero
  for (int q = threadIdx.x; q < t_elems * 2 / 16; q += kThreads)
    reinterpret_cast<uint4*>(tmap)[q] = make_uint4(0, 0, 0, 0);
  store_map<N>(acc, smem_u32(hmap), trash, g);
  __syncthreads();
  push_halos(hmap, g, cluster);
  fence_proxy_async();
  cluster_arrive();
  cluster_wait();
  fence_proxy_async();

  // The 2K Hd×Hd convs: conv 2k reads H and writes T; conv 2k+1 reads T,
  // adds into h and, unless it is the last, writes H.
  const float* biases = w_in + a.C_in * 9 * a.Hd;
  int chunk = 0;
  for (int k = 0; k < n_convs; ++k) {
    const bool second = k & 1, last = k == n_convs - 1;
    conv_gmma<N>(acc, smem_u32(second ? tmap : hmap), ring, zero, g, chunk);
    if (g.live()) {
      const float b_lo = __ldg(biases + k * a.Hd + g.channel(0));
      const float b_hi = __ldg(biases + k * a.Hd + g.channel(1));
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        float4 v = make_float4(acc[4 * j] + b_lo, acc[4 * j + 1] + b_lo, acc[4 * j + 2] + b_hi,
                               acc[4 * j + 3] + b_hi);
        if (second) {
          float4* h = reinterpret_cast<float4*>(hreg + g.h_index<N>(j));
          const float4 old = *h;
          v = make_float4(v.x + old.x, v.y + old.y, v.z + old.z, v.w + old.w);
          *h = v;
        }
        acc[4 * j] = v.x, acc[4 * j + 1] = v.y, acc[4 * j + 2] = v.z, acc[4 * j + 3] = v.w;
      }
    }
    if (!last) {
      __nv_bfloat16* out_map = second ? hmap : tmap;
      store_map<N>(acc, smem_u32(out_map), trash, g);
      __syncthreads();
      push_halos(out_map, g, cluster);
      fence_proxy_async();
      cluster_arrive();
      cluster_wait();
      fence_proxy_async();
    }
  }
  __syncthreads();  // h complete

  // relu → 1×1 conv + b → head_w·tanh + head_b, on the band's own pixels.
  const float* w_out = biases + n_convs * a.Hd;
  const float* b_out = w_out + a.Hd * a.C_out;
  const float* head_w = b_out + a.C_out;
  const float* head_b = head_w + a.C_out;
  const int P = rows * W;
  float* ob = a.out + (size_t)img * a.C_out * a.H * W + (size_t)r0 * W;
  for (int q = threadIdx.x; q < a.C_out * P; q += kThreads) {
    const int o = q / P, p = q - o * P;
    const int row = p / W, n = p + row;  // band pixel row·(W+1) + col
    const int wg = n / N, nn = n - wg * N;
    // Channel i of pixel n is element 4·(nn/8) + 2·((i/8)%2) + nn%2 of lane
    // 4·(i%8) + (nn%8)/2 of warp i/16.
    const int base = ((wg * (N / 8) + (nn >> 3)) * (2 * Cm) + ((nn & 7) >> 1)) * 4 + (nn & 1);
    float s = 0.f;
    for (int i = 0; i < Cm; ++i) {
      const int idx = base + ((i >> 4) * 32 + ((i & 7) << 2)) * 4 + ((i >> 3) & 1) * 2;
      s = fmaf(__ldg(w_out + i * a.C_out + o), fmaxf(hreg[idx], 0.f), s);
    }
    ob[(size_t)o * a.H * W + p] = __ldg(head_w + o) * tanhf(s + __ldg(b_out + o)) + __ldg(head_b + o);
  }
}

// The widths N of the instance set (ops/coupler_stack.py::BF16_WIDTHS).
#define CMF_BF16_DISPATCH(n, CALL)  \
  switch (n) {                      \
    case 32: return CALL(32);       \
    case 64: return CALL(64);       \
    case 104: return CALL(104);     \
    case 112: return CALL(112);     \
    case 136: return CALL(136);     \
    case 160: return CALL(160);     \
    case 184: return CALL(184);     \
    case 208: return CALL(208);     \
    case 232: return CALL(232);     \
    case 256: return CALL(256);     \
    default: return cudaErrorInvalidValue; \
  }

int smem_bytes(int C_in, int Cm, int n, int map_px, int stages) {
  return kHeadBytes + stages * kStageBytes + 2 * Cm * map_px + 2 * max(Cm, C_in) * map_px + 4 * Cm * 2 * n;
}

// The bf16 plan (ops/coupler_stack.py::plan_launch_bf16), checked again.
bool plan_ok(int C_in, int H, int W, int Hd, int Cm, int cluster, int n, int map_px, int stages) {
  if (H < 1 || W < 1 || C_in < 1 || (Hd != 32 && Hd != 64) || C_in > Hd) return false;
  if (Cm < 16 || Cm > Hd || Cm % 16 != 0) return false;
  if (cluster < 1 || cluster > kMaxCluster || cluster > H) return false;
  if (stages < 2 || stages > kMaxStages) return false;
  const int rows = (H + cluster - 1) / cluster;
  if (kWarpgroups * n < rows * (W + 1)) return false;
  if (map_px % 8 != 0 || map_px < kWarpgroups * n + 2 * (W + 1) + 2) return false;
  return smem_bytes(C_in, Cm, n, map_px, stages) <= kSmemLimit;
}

cudaError_t launch_any(const Args& a, int B, int n, cudaStream_t stream) {
  const int smem = smem_bytes(a.C_in, a.Cm, n, a.map_px, a.stages);
#define CMF_LAUNCH(N) launch(coupler_stack_bf16_kernel<N>, a, kThreads, B, smem, stream)
  CMF_BF16_DISPATCH(n, CMF_LAUNCH)
#undef CMF_LAUNCH
}

cudaError_t max_clusters_any(int n, int cluster, int smem, int* count) {
#define CMF_OCCUPANCY(N) max_clusters(coupler_stack_bf16_kernel<N>, kThreads, cluster, smem, count)
  CMF_BF16_DISPATCH(n, CMF_OCCUPANCY)
#undef CMF_OCCUPANCY
}

int forward(const void* x, const void* wts, const void* small, void* out, int B, int C_in, int H, int W,
            int Hd, int Cm, int num_blocks, int C_out, int cluster, int n, int map_px, int stages,
            void* stream) {
  if (B < 1 || num_blocks < 0 || C_out < 1 || !plan_ok(C_in, H, W, Hd, Cm, cluster, n, map_px, stages))
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)x, (const __nv_bfloat16*)wts, (const float*)small, (float*)out,
         C_in, H, W, Hd, Cm, num_blocks, C_out, cluster, map_px, stages};
  const cudaError_t e = launch_any(a, B, n, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace bf

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors: x (B, C_in, H, W) fp32; frags and small packed by
// ops/coupler_stack.py::pack_weights (frags fp32 hi/lo TF32 fragments, small
// fp32); out (B, C_out, H, W) fp32. Hd is the hidden width padded to 32 or
// 64; cluster, S (map stride in floats) and kc (input channels per weight
// chunk) are the launch plan. The kernel runs on `stream`; the return value
// is the launch's error, then cudaGetLastError() (0 = launched).
extern "C" int cmf_coupler_stack_fwd(const void* x, const void* frags, const void* small, void* out,
                                     int B, int C_in, int H, int W, int Hd, int num_blocks,
                                     int C_out, int cluster, int S, int kc, void* stream) {
  return forward(x, frags, small, out, B, C_in, H, W, Hd, num_blocks, C_out, cluster, S, kc, stream);
}

// The bf16=True arithmetic: wts the bf16 A tiles of pack_weights(bf16=True),
// small as above; Cm the hidden width padded to 16; cluster, n (pixels a
// warpgroup), map_px (pixels a map) and stages (weight ring) the
// launch plan of ops/coupler_stack.py::plan_launch_bf16.
extern "C" int cmf_coupler_stack_fwd_bf16(const void* x, const void* wts, const void* small, void* out,
                                          int B, int C_in, int H, int W, int Hd, int Cm, int num_blocks,
                                          int C_out, int cluster, int n, int map_px, int stages,
                                          void* stream) {
  return bf::forward(x, wts, small, out, B, C_in, H, W, Hd, Cm, num_blocks, C_out, cluster, n, map_px,
                     stages, stream);
}

// How many clusters of this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), for the smoke run's report. Returns the
// CUDA error, 0 on success.
extern "C" int cmf_coupler_stack_max_clusters(int H, int W, int Hd, int cluster, int S, int kc, int* n) {
  if (!plan_ok(1, H, W, Hd, cluster, S, kc)) return (int)cudaErrorInvalidValue;
  return (int)max_clusters_any(Hd, tiles_per_warp(H, W, cluster), kc, cluster, smem_bytes(Hd, S, kc), n);
}

// The same for a bf16 plan.
extern "C" int cmf_coupler_stack_max_clusters_bf16(int C_in, int H, int W, int Hd, int Cm, int cluster, int n,
                                                   int map_px, int stages, int* count) {
  if (!bf::plan_ok(C_in, H, W, Hd, Cm, cluster, n, map_px, stages)) return (int)cudaErrorInvalidValue;
  return (int)bf::max_clusters_any(n, cluster, bf::smem_bytes(C_in, Cm, n, map_px, stages), count);
}
