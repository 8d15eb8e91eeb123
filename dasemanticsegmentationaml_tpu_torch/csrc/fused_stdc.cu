// A whole inference-mode STDC CatBottleneck in one launch, for Hopper.
//
// Replaces the Pallas TPU kernels
// dasemanticsegmentationaml_tpu/ops/pallas/fused_stdc.py
// (fused_cat_bottleneck :424; fused_cat_s1 :326 / _kernel_s1 :168;
// fused_cat_s2 :376 / _kernel_s2 :203). One CatBottleneck (reference
// stdcnet.py:66-113) with BN folded into the convolutions (the wrapper's
// fold_cat_params):
//   x1 = relu(conv1x1(x) + b1)                              (h1 channels)
//   stride 1: head = x1, a = x1
//   stride 2: head = avgpool3x3/s2/pad1(x1)  (count_include_pad, * 1/9)
//             a    = dwconv3x3/s2/pad1(x1) + avd_b          (no ReLU)
//   x2 = relu(conv3x3(a) + b2), x3 = relu(conv3x3(x2) + b3),
//   x4 = relu(conv3x3(x3) + b4)
//   out = concat(head, x2, x3, x4) over channels, NCHW.
// Operands in the input type T (fp32 or bf16), fp32 sums, fp32 bias and
// ReLU, every intermediate rounded to T and zero outside the image: the
// zero padding PyTorch gives every intermediate, which the TPU kernel
// re-creates with _mask (:119-131).
//
// Bound on this card. The six STDC813 bottlenecks at batch 8 and 1024x512
// hold 57.0 GMAC of 1x1 and 3x3 convolution: 0.115 ms on the bf16 tensor
// cores (989 TFLOP/s); with their bytes (input, concat, weights) each
// launch sits near the line between the two bounds
// (chip_smoke.py::bound_cat).
//
// bf16 body (namespace tc): the convolutions on the tensor cores.
//   * Phases over the whole grid. The launch is cooperative: every block is
//     resident, and a grid barrier separates the phases: the entry conv
//     (x1), at stride 2 the avd conv and pool (avd_pool), then x2, x3 and
//     x4. Each phase reads the one before from device memory, where it
//     mostly sits in L2: besides the concat (NCHW), every intermediate a
//     later phase reads is written pixel-major (NHWC, channels zero-padded
//     to whole chunks; at stride 2 x1 at full resolution). So no block
//     recomputes a neighbour's halo: the plan does 60.7 GMAC for the 57.0
//     useful (the padding of 32 output channels to 64 at features[2:4]).
//   * Items. A phase is a list of items (image, output tile, block of 64
//     output channels) that the grid walks in a fixed order, so every
//     output comes from one item and one order of sums: two runs are
//     bit-identical, and nothing is atomic but the barrier's count.
//   * Implicit GEMM on mma.sync.m16n8k16 (bf16 in, fp32 sums). A block is
//     four warps, 2 along the pixels x 2 along the channels; a warp holds
//     16 MT pixels x 32 channels of sums (MT 4, or 2 where 128-pixel
//     tiles would leave SMs without an item). The input streams into two
//     shared-memory buffers by cp.async, chunk kc + 1 in flight while
//     chunk kc's taps run: a 3x3 phase's pixel-major source with its
//     one-pixel halo, at a row pitch of kc + 8 (odd in 16-byte units, so
//     ldmatrix's eight rows hit eight bank groups); a 3x3 tap is the same
//     GEMM over shifted rows, and ldmatrix takes one row address a lane,
//     so the shift costs nothing. The entry's NCHW x streams channel-major
//     and ldmatrix .trans turns it into the same fragments.
//     mma.sync, not wgmma, in this design: each warp takes its shifted rows
//     straight from ldmatrix, and a tile is any multiple of 16 rows, which
//     the 16 x 32 maps of features[6:8] need to give every SM an item.
//     wgmma (A from registers in the same fragments, B by a descriptor
//     over the slice) is the next step for the large phases (PERF.md §7).
//   * Weights: bf16, packed by the wrapper into slices (one output-channel
//     block x kc channels x one tap) already in the shared-memory layout
//     ldmatrix reads, streamed by cp.async.bulk into a 3-slot ring on
//     mbarriers (tma_ring.cuh), so the next slices load while the MMAs run.
//   * Epilogue: bias, ReLU and bf16 into a pixel-major tile in shared
//     memory, which leaves in 16-byte vectors, to the concat and to the
//     next phase's source.
//   * avd_pool, the stride-2 depthwise avd conv and average pool, runs on
//     CUDA cores in fp32 from the x1 pixels its tile reads.

// fp32 body (namespace below): the CUDA-core design of the first port,
// kept because no path times fp32 and TF32 misses its 1e-4 bound. One
// block owns a th x tw tile of output pixels of one image and recomputes
// its halo, so blocks share nothing and run in any order. The chain
// x2 <- x3 <- x4 needs 3 extra pixels on each side at output resolution:
//   stride 1: x1 over the tile + 3 -> shared buffer A; x2 over the tile + 2
//             -> buffer B; x3 over the tile + 1 -> A (x1 is dead); x4 over
//             the tile -> device memory.
//   stride 2: the avd output over the tile + 3 at half resolution lives in
//             A. x1 is needed at full resolution over 2 (t + 6) + 1 pixels
//             a side; both avd and the pool are depthwise, so x1 is
//             computed `chunk` channels at a time into B, each chunk feeds
//             avd (into A) and the pool (straight to device memory) and is
//             dropped. Then x2 -> B, x3 -> A, x4 -> device memory.
// A stage is an implicit GEMM on CUDA cores: a warp takes 32 * PM output
// pixels (lane-strided, so the shared-memory reads of a warp are
// consecutive) times 8 output channels; each thread keeps PM x 8 fp32 sums
// in registers, reads its PM activations from shared memory (the entry
// conv from device memory) and the 8 weights as two broadcast float4
// loads, from fp32 copies packed (Cin * kh * kw, Cout padded to 8).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 8;  // output channels per thread

// The fp32 body is written for an element type T, instantiated for float
// only (the bf16 body is namespace tc below).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

struct Params {
  const void* x;
  void* out;
  const float *w1, *b1, *k2, *b2, *k3, *b3, *k4, *b4, *avd, *avd_b;
  int B, cin, H, W, h1, h2, h3, h4, Ho, Wo, th, tw, chunk, off_b;
};

// A rectangle of image pixels: origin (y0, x0) in image coordinates (may
// lie outside the image), h x w pixels, row-major local index p = r*w + c.
struct Region {
  int y0, x0, h, w;
  __device__ int size() const { return h * w; }
};

// Where a stage's outputs go. smem: [cout][region] in T, or null. out: the
// image's (Cout, img_h, img_w) output; the tile's pixels [ty0, ty0 + th) x
// [tx0, tx0 + tw) are written at channel ch_off + co, or null.
template <typename T>
struct Sink {
  T* smem;
  T* out;
  int ch_off, img_h, img_w, ty0, tx0, th, tw;
  bool relu;
};

__device__ __forceinline__ int pick_pm(int npix) {
  const int p1 = (npix + 31) / 32 * 32;
  const int p2 = (npix + 63) / 64 * 64;
  const int p4 = (npix + 127) / 128 * 128;
  if (p4 * 8 <= p1 * 9) return 4;
  if (p2 * 8 <= p1 * 9) return 2;
  return 1;
}

// bias + (ReLU) + zero outside the image + round to T, then store.
template <typename T, int PM>
__device__ __forceinline__ void epilogue(const float (&acc)[PM][kQ],
                                         const int (&pix)[PM],
                                         const Region& R, int co0, int cout,
                                         const float* __restrict__ bias,
                                         const Sink<T>& sk) {
  const int npix = R.size();
  float bv[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) bv[q] = __ldg(bias + co0 + q);
#pragma unroll
  for (int j = 0; j < PM; ++j) {
    const int p = pix[j];
    if (p >= npix) continue;
    const int r = p / R.w, c = p - r * R.w;
    const int gy = R.y0 + r, gx = R.x0 + c;
    const bool in_img = gy >= 0 && gy < sk.img_h && gx >= 0 && gx < sk.img_w;
    const bool own = sk.out != nullptr && in_img && gy >= sk.ty0 &&
                     gy < sk.ty0 + sk.th && gx >= sk.tx0 && gx < sk.tx0 + sk.tw;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int co = co0 + q;
      if (co >= cout) break;
      float v = acc[j][q] + bv[q];
      if (sk.relu) v = fmaxf(v, 0.0f);
      const T tv = from_f32<T>(in_img ? v : 0.0f);
      if (sk.smem != nullptr) sk.smem[co * npix + p] = tv;
      if (own)
        sk.out[((int64_t)(sk.ch_off + co) * sk.img_h + gy) * sk.img_w + gx] = tv;
    }
  }
}

__device__ __forceinline__ void fma8(float (&acc)[kQ], float a, const float4& wa,
                                     const float4& wb) {
  acc[0] = fmaf(a, wa.x, acc[0]);
  acc[1] = fmaf(a, wa.y, acc[1]);
  acc[2] = fmaf(a, wa.z, acc[2]);
  acc[3] = fmaf(a, wa.w, acc[3]);
  acc[4] = fmaf(a, wb.x, acc[4]);
  acc[5] = fmaf(a, wb.y, acc[5]);
  acc[6] = fmaf(a, wb.z, acc[6]);
  acc[7] = fmaf(a, wb.w, acc[7]);
}

// 3x3 stride-1 conv over a shared-memory region: src is [cin][R.h+2][R.w+2]
// around the output region R. wk: (cin * 9, ld) fp32, row ci*9 + kh*3 + kw.
template <typename T, int PM>
__device__ void conv3x3_items(const T* __restrict__ src, int cin,
                              const Region& R, const float* __restrict__ wk,
                              int ld, int cout, const float* __restrict__ bias,
                              const Sink<T>& sk) {
  const int npix = R.size();
  const int in_w = R.w + 2, in_plane = (R.h + 2) * in_w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (npix + 32 * PM - 1) / (32 * PM);
  const int groups = (cout + kQ - 1) / kQ;
  for (int item = warp; item < chunks * groups; item += kWarps) {
    const int pc = item % chunks, co0 = (item / chunks) * kQ;
    int pix[PM], off[PM];
#pragma unroll
    for (int j = 0; j < PM; ++j) {
      const int p = pc * 32 * PM + j * 32 + lane;
      pix[j] = p;
      const int pp = p < npix ? p : 0;
      const int r = pp / R.w, c = pp - r * R.w;
      off[j] = r * in_w + c;
    }
    float acc[PM][kQ];
#pragma unroll
    for (int j = 0; j < PM; ++j)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[j][q] = 0.0f;
    for (int ci = 0; ci < cin; ++ci) {
      const T* s = src + ci * in_plane;
      const float* w = wk + (int64_t)ci * 9 * ld + co0;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float* wt = w + (kh * 3 + kw) * ld;
          const float4 wa = __ldg(reinterpret_cast<const float4*>(wt));
          const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + 4));
#pragma unroll
          for (int j = 0; j < PM; ++j)
            fma8(acc[j], to_f32(s[off[j] + kh * in_w + kw]), wa, wb);
        }
      }
    }
    epilogue<T, PM>(acc, pix, R, co0, cout, bias, sk);
  }
}

template <typename T>
__device__ void conv3x3(const T* src, int cin, const Region& R,
                        const float* wk, int ld, int cout, const float* bias,
                        const Sink<T>& sk) {
  switch (pick_pm(R.size())) {
    case 4: conv3x3_items<T, 4>(src, cin, R, wk, ld, cout, bias, sk); break;
    case 2: conv3x3_items<T, 2>(src, cin, R, wk, ld, cout, bias, sk); break;
    default: conv3x3_items<T, 1>(src, cin, R, wk, ld, cout, bias, sk); break;
  }
}

// 1x1 conv of the block's image x (cin, H, W) in device memory over the
// region R (zero input outside the image). wk: (cin, ld) fp32.
template <typename T, int PM>
__device__ void conv1x1_items(const T* __restrict__ x, int cin, int H, int W,
                              const Region& R, const float* __restrict__ wk,
                              int ld, int cout, const float* __restrict__ bias,
                              const Sink<T>& sk) {
  const int npix = R.size();
  const int64_t plane = (int64_t)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (npix + 32 * PM - 1) / (32 * PM);
  const int groups = (cout + kQ - 1) / kQ;
  for (int item = warp; item < chunks * groups; item += kWarps) {
    const int pc = item % chunks, co0 = (item / chunks) * kQ;
    int pix[PM], off[PM];
#pragma unroll
    for (int j = 0; j < PM; ++j) {
      const int p = pc * 32 * PM + j * 32 + lane;
      pix[j] = p;
      const int r = p / R.w, c = p - r * R.w;
      const int gy = R.y0 + r, gx = R.x0 + c;
      off[j] = (p < npix && gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? gy * W + gx : -1;
    }
    float acc[PM][kQ];
#pragma unroll
    for (int j = 0; j < PM; ++j)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[j][q] = 0.0f;
#pragma unroll 4
    for (int ci = 0; ci < cin; ++ci) {
      const T* s = x + ci * plane;
      const float* wt = wk + (int64_t)ci * ld + co0;
      const float4 wa = __ldg(reinterpret_cast<const float4*>(wt));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + 4));
#pragma unroll
      for (int j = 0; j < PM; ++j)
        fma8(acc[j], off[j] >= 0 ? ldg_f32(s + off[j]) : 0.0f, wa, wb);
    }
    epilogue<T, PM>(acc, pix, R, co0, cout, bias, sk);
  }
}

template <typename T>
__device__ void conv1x1(const T* x, int cin, int H, int W, const Region& R,
                        const float* wk, int ld, int cout, const float* bias,
                        const Sink<T>& sk) {
  switch (pick_pm(R.size())) {
    case 4: conv1x1_items<T, 4>(x, cin, H, W, R, wk, ld, cout, bias, sk); break;
    case 2: conv1x1_items<T, 2>(x, cin, H, W, R, wk, ld, cout, bias, sk); break;
    default: conv1x1_items<T, 1>(x, cin, H, W, R, wk, ld, cout, bias, sk); break;
  }
}

__device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_cat_s1_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf_a = reinterpret_cast<T*>(smem);
  T* buf_b = reinterpret_cast<T*>(smem + p.off_b);
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * p.th, tx0 = blockIdx.x * p.tw;
  const int cout = p.h1 + p.h2 + p.h3 + p.h4;
  const T* x = static_cast<const T*>(p.x) + (int64_t)b * p.cin * p.H * p.W;
  T* out = static_cast<T*>(p.out) + (int64_t)b * cout * p.Ho * p.Wo;
  const Region r1{ty0 - 3, tx0 - 3, p.th + 6, p.tw + 6};
  const Region r2{ty0 - 2, tx0 - 2, p.th + 4, p.tw + 4};
  const Region r3{ty0 - 1, tx0 - 1, p.th + 2, p.tw + 2};
  const Region r4{ty0, tx0, p.th, p.tw};
  Sink<T> sk{buf_a, out, 0, p.Ho, p.Wo, ty0, tx0, p.th, p.tw, true};

  conv1x1<T>(x, p.cin, p.H, p.W, r1, p.w1, round_up(p.h1, 32), p.h1, p.b1, sk);
  __syncthreads();
  sk.smem = buf_b;
  sk.ch_off = p.h1;
  conv3x3<T>(buf_a, p.h1, r2, p.k2, round_up(p.h2, kQ), p.h2, p.b2, sk);
  __syncthreads();
  sk.smem = buf_a;
  sk.ch_off = p.h1 + p.h2;
  conv3x3<T>(buf_b, p.h2, r3, p.k3, round_up(p.h3, kQ), p.h3, p.b3, sk);
  __syncthreads();
  sk.smem = nullptr;
  sk.ch_off = p.h1 + p.h2 + p.h3;
  conv3x3<T>(buf_a, p.h3, r4, p.k4, round_up(p.h4, kQ), p.h4, p.b4, sk);
}

// One chunk of x1 (nch channels from c0) at full resolution over F -> the
// avd output over the half-resolution region R1 (into avd_s, channels
// c0..c0+nch) and the average pool over the block's tile (to device memory).
template <typename T>
__device__ void avd_pool_chunk(const T* __restrict__ x1, const Region& F,
                               const Region& R1, int c0, int nch,
                               const float* __restrict__ avd_w,
                               const float* __restrict__ avd_b,
                               T* __restrict__ avd_s, int Ho, int Wo, int ty0,
                               int tx0, int th, int tw, T* __restrict__ out) {
  const int nf = F.size(), n1 = R1.size();
  for (int i = threadIdx.x; i < nch * n1; i += blockDim.x) {
    const int c = i / n1, p = i - c * n1;
    const int r = p / R1.w, cc = p - r * R1.w;
    const int gy = R1.y0 + r, gx = R1.x0 + cc;
    float v = 0.0f;
    if (gy >= 0 && gy < Ho && gx >= 0 && gx < Wo) {
      // half-res (r, cc) reads full-res rows 2r..2r+2, cols 2cc..2cc+2 of F
      const T* s = x1 + c * nf + 2 * r * F.w + 2 * cc;
      const float* w = avd_w + (c0 + c) * 9;
      float acc = 0.0f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          acc = fmaf(to_f32(s[kh * F.w + kw]), __ldg(w + kh * 3 + kw), acc);
      v = acc + __ldg(avd_b + c0 + c);
    }
    avd_s[(c0 + c) * n1 + p] = from_f32<T>(v);
  }
  const int nt = th * tw;
  for (int i = threadIdx.x; i < nch * nt; i += blockDim.x) {
    const int c = i / nt, p = i - c * nt;
    const int r = p / tw, cc = p - r * tw;
    const int gy = ty0 + r, gx = tx0 + cc;
    if (gy >= Ho || gx >= Wo) continue;
    // the tile's (r, cc) is (r + 3, cc + 3) of R1
    const T* s = x1 + c * nf + 2 * (r + 3) * F.w + 2 * (cc + 3);
    float acc = 0.0f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) acc += to_f32(s[kh * F.w + kw]);
    out[((int64_t)(c0 + c) * Ho + gy) * Wo + gx] =
        from_f32<T>(acc * (1.0f / 9.0f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_cat_s2_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf_a = reinterpret_cast<T*>(smem);          // avd, then x3
  T* buf_b = reinterpret_cast<T*>(smem + p.off_b);  // x1 chunks, then x2
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * p.th, tx0 = blockIdx.x * p.tw;
  const int cout = p.h1 + p.h2 + p.h3 + p.h4;
  const T* x = static_cast<const T*>(p.x) + (int64_t)b * p.cin * p.H * p.W;
  T* out = static_cast<T*>(p.out) + (int64_t)b * cout * p.Ho * p.Wo;
  const Region r1{ty0 - 3, tx0 - 3, p.th + 6, p.tw + 6};
  const Region r2{ty0 - 2, tx0 - 2, p.th + 4, p.tw + 4};
  const Region r3{ty0 - 1, tx0 - 1, p.th + 2, p.tw + 2};
  const Region r4{ty0, tx0, p.th, p.tw};
  // full-resolution x1 under r1: rows 2 * r1.y0 - 1 .. 2 * (r1.y0 + r1.h - 1) + 1
  const Region f{2 * r1.y0 - 1, 2 * r1.x0 - 1, 2 * r1.h + 1, 2 * r1.w + 1};
  const int ld1 = round_up(p.h1, 32);

  for (int c0 = 0; c0 < p.h1; c0 += p.chunk) {
    const int nch = min(p.chunk, p.h1 - c0);
    const Sink<T> x1_sink{buf_b, nullptr, 0, p.H, p.W, 0, 0, 0, 0, true};
    conv1x1<T>(x, p.cin, p.H, p.W, f, p.w1 + c0, ld1, nch, p.b1 + c0, x1_sink);
    __syncthreads();
    avd_pool_chunk<T>(buf_b, f, r1, c0, nch, p.avd, p.avd_b, buf_a, p.Ho,
                      p.Wo, ty0, tx0, p.th, p.tw, out);
    __syncthreads();
  }
  Sink<T> sk{buf_b, out, p.h1, p.Ho, p.Wo, ty0, tx0, p.th, p.tw, true};
  conv3x3<T>(buf_a, p.h1, r2, p.k2, round_up(p.h2, kQ), p.h2, p.b2, sk);
  __syncthreads();
  sk.smem = buf_a;
  sk.ch_off = p.h1 + p.h2;
  conv3x3<T>(buf_b, p.h2, r3, p.k3, round_up(p.h3, kQ), p.h3, p.b3, sk);
  __syncthreads();
  sk.smem = nullptr;
  sk.ch_off = p.h1 + p.h2 + p.h3;
  conv3x3<T>(buf_a, p.h3, r4, p.k4, round_up(p.h4, kQ), p.h4, p.b4, sk);
}

template <typename T, int S>
int launch(const void* x, void* out, const void* w1, const void* b1,
           const void* k2, const void* b2, const void* k3, const void* b3,
           const void* k4, const void* b4, const void* avd, const void* avd_b,
           int B, int cin, int H, int W, int h1, int h2, int h3, int h4,
           int Ho, int Wo, int th, int tw, int chunk, int off_b, int smem,
           void* stream) {
  Params p{x, out,
           (const float*)w1, (const float*)b1, (const float*)k2,
           (const float*)b2, (const float*)k3, (const float*)b3,
           (const float*)k4, (const float*)b4, (const float*)avd,
           (const float*)avd_b,
           B, cin, H, W, h1, h2, h3, h4, Ho, Wo, th, tw, chunk, off_b};
  void (*kernel)(Params) =
      S == 1 ? fused_cat_s1_kernel<T> : fused_cat_s2_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Wo + tw - 1) / tw), (unsigned)((Ho + th - 1) / th),
                  (unsigned)B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 body: tensor cores, a weight ring, stages over the whole grid.
// ---------------------------------------------------------------------------

namespace tc {

using namespace tma_ring;

constexpr int kThreads = 128;   // four warps: 2 along M x 2 along N
constexpr int kBN = 64;         // output channels of one item
constexpr int kNS = 3;          // slots of the weight ring
constexpr int kSlotBytes = kBN * (64 + 8) * 2;  // the largest slice
constexpr int kX1Ld = kBN + 8;  // row pitch of the 64-channel tiles

// One GEMM stage of the bottleneck (the 1x1 entry conv or a 3x3 ConvX), as
// the wrapper plans it (ops/cuda/fused_stdc.py::TcStage). The packed weights
// w are (nblk, nk, taps, 64, kc + 8) bf16: one slice per (item's channel
// block, input chunk, tap), each already in the shared-memory layout the
// MMA reads (output channel rows, kc input channels, 8 of padding), so one
// bulk copy moves it. bias: fp32, nblk * 64. The entry reads x (NCHW, src_c
// channels); a 3x3 stage reads the stage before's output pixel-major (NHWC,
// src_c = its nk * kc channels a pixel, zero past cin). mid: where a stage
// that feeds another writes its output pixel-major (mid_c channels a
// pixel, zero past cout), beside the concat; null for x4.
struct Stage {
  const __nv_bfloat16* w;
  const float* bias;
  const __nv_bfloat16* src;
  __nv_bfloat16* mid;
  int src_c, mid_c;
  int src_h, src_w;
  int cin, cout, out_off;    // out_off: channel offset in the concat
  int kc, nk, taps, nblk;    // chunk, chunks, 1 or 9 taps, channel blocks
  int mt, th, tw;            // 16 * mt rows a warp; the output tile
  int tiles_y, tiles_x, items;
  int buf_bytes;             // the pitch of its two staging buffers
};

struct Params {
  Stage st[4];
  __nv_bfloat16* out;
  const float* avd_w;        // stride 2: the avd conv, (h1, 9) fp32
  const float* avd_b;
  unsigned int* bar;         // the grid barrier's count, 0 at launch
  int B, ctot, Ho, Wo;
  int off_act;               // byte offset of the staging buffers
  int dw_th, dw_tw, dw_tiles_y, dw_tiles_x, dw_items;  // stride 2: avd_pool
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A (16 x 16, row-major) B (16 x 8, column-major); bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every block arrives once per barrier; the k-th barrier of a launch
// returns when the count reaches k * gridDim.x. A cooperative launch keeps
// every block resident, so the wait ends; a wait past 2^32 cycles can only
// be a fault, and traps, as mbar_wait does. The fence publishes the
// block's stores of the stage before; the later stages read them with
// ld.global.cg (L2), never through the non-coherent path.
__device__ __forceinline__ void grid_sync(unsigned int* count,
                                          unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long start = clock64();
    unsigned int seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (seen >= target) break;
      if (clock64() - start > (1ll << 32)) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The weight ring: kNS slots of one slice each. Thread 0 issues the bulk
// loads (and alone keeps head, base and the item's counts); every thread
// waits on the slot's mbarrier. Loads and uses run in one order over the
// whole launch, so use number u finds its slice in slot u % kNS at phase
// parity (u / kNS) & 1. An item's slices are s = 0 .. count - 1, at
// base + s * bytes.
struct Ring {
  uint32_t slots, bars;
  uint32_t head, tail;  // loads issued, slices used, over the launch
  const char* base;
  int bytes, count, issued;

  __device__ void issue() {
    const uint32_t slot = head % kNS;
    mbar_expect_tx(bars + 8 * slot, (uint32_t)bytes);
    bulk_load(slots + slot * kSlotBytes, base + (size_t)issued * bytes,
              (uint32_t)bytes, bars + 8 * slot);
    ++head;
    ++issued;
  }
  // a new item: its first slices go out at once, ahead of its staging
  __device__ void begin(const char* b, int slice_bytes, int n) {
    if (threadIdx.x != 0) return;
    base = b;
    bytes = slice_bytes;
    count = n;
    issued = 0;
    while (issued < count && issued < kNS) issue();
  }
  __device__ uint32_t wait() const {
    const uint32_t slot = tail % kNS;
    mbar_wait(bars + 8 * slot, (tail / kNS) & 1u);
    return slots + slot * kSlotBytes;
  }
  // every warp is done with the slot (and, after a chunk's last tap, with
  // its staged input); thread 0 refills it with the next slice
  __device__ void release() {
    __syncthreads();
    ++tail;
    if (threadIdx.x == 0 && issued < count) issue();
  }
};

// 16 bytes global -> shared without registers (cp.async, Ampere's
// asynchronous copy); a source of 0 bytes fills the 16 with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x kc channels of a pixel-major source (c channels a pixel) into
// shared memory, pixel-major: act[p][k] at p * (kc + 8) + k, for the
// region's pixel p (rw pixels wide from (y0, x0)), by cp.async: a pixel's
// chunk is kc / 8 16-byte vectors, neighbouring lanes on neighbouring
// vectors; a pixel outside the image reads as zeros.
__device__ __forceinline__ void stage_nhwc(uint32_t act, const __nv_bfloat16* img,
                                           int c, int H, int W, int c0,
                                           int kc, int rows, int y0, int x0,
                                           int rw) {
  const int vecs = kc >> 3, ld = (kc + 8) * 2;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int p = i / vecs, v = i - p * vecs;
    const int pr = p / rw, gy = y0 + pr, gx = x0 + p - pr * rw;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* e =
        ok ? img + ((int64_t)gy * W + gx) * c + c0 + 8 * v : img;
    cp_async16(act + p * ld + v * 16, e, ok);
  }
}

// One slice: ksteps steps of 16 input channels, the warp's 16 * MT rows
// times 32 output channels; B is the slice. A comes from the staged input
// by ldmatrix, one row address a lane: aoff[mt] is the lane's byte offset
// for step 0 and astep the step's. Pixel-major (a 3x3 stage), a lane's row
// is a pixel, shifted by the tap, so the shifted window of the implicit
// GEMM needs no copy; channel-major (the entry), .trans turns 8 channels x
// 8 pixels into the same fragment.
template <int MT, bool TRANS>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][4][4],
                                          uint32_t act, const int (&aoff)[MT],
                                          int astep, uint32_t wslot, int ld,
                                          int ksteps, int brow, int bkofs) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[MT][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t addr = act + (uint32_t)(aoff[mt] + ks * astep);
      if (TRANS)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]), "=r"(a[mt][3])
            : "r"(addr));
      else
        ldsm_x4(a[mt], addr);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, wslot + (uint32_t)((brow + np * 16) * ld) +
                     (uint32_t)((ks * 16 + bkofs) * 2));
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

struct Lane {
  int lane, warp_m, warp_n, brow, bkofs;
  __device__ Lane() {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    warp_m = warp & 1;
    warp_n = warp >> 1;
    brow = warp_n * 32 + (lane & 7) + 8 * (lane >> 4);
    bkofs = 8 * ((lane >> 3) & 1);
  }
};

// kc channels x the tile's th x tw pixels of an NCHW source into shared
// memory channel-major: raw[k][m] at k * (th tw + 8) + m, m = r * tw + c
// (a row pitch odd in 16-byte units: .trans's 8 rows on 8 bank groups).
// Where W and the tile's columns are multiples of 8, by cp.async, a
// 16-byte vector of 8 pixels a copy, all inside the image or all outside;
// otherwise by plain loads, neighbouring lanes on neighbouring pixels.
// Zero outside the image and past nch channels.
__device__ __forceinline__ void stage_nchw(uint32_t raw_s, __nv_bfloat16* raw,
                                           bool async, const __nv_bfloat16* img,
                                           int64_t plane, int H, int W,
                                           int nch, int kc, int th, int tw,
                                           int y0, int x0) {
  const int bm = th * tw, ldm = bm + 8;
  if (async) {
    const int vecs = tw >> 3;
    for (int i = threadIdx.x; i < kc * th * vecs; i += kThreads) {
      const int v = i % vecs, kr = i / vecs, r = kr % th, k = kr / th;
      const int gy = y0 + r, gx = x0 + 8 * v;
      const bool ok = k < nch && gy < H && gx < W;
      const __nv_bfloat16* e = ok ? img + k * plane + gy * W + gx : img;
      cp_async16(raw_s + (uint32_t)((k * ldm + r * tw + 8 * v) * 2), e, ok);
    }
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(img);
  unsigned short* d = reinterpret_cast<unsigned short*>(raw);
  for (int i = threadIdx.x; i < kc * bm; i += kThreads) {
    const int k = i / bm, m = i - k * bm;
    const int gy = y0 + m / tw, gx = x0 + m % tw;
    d[k * ldm + m] = (k < nch && gy < H && gx < W)
                         ? __ldcg(s + k * plane + gy * W + gx)
                         : (unsigned short)0;
  }
}

// nco channels of a pixel-major tile in shared memory (th x tw pixels, 64 +
// 8 bf16 a row) to an NCHW map H x W from (ty0, tx0), channel c at
// dst + c H W: 8 pixels of a tile row a 16-byte vector where the map's
// width allows it (neighbouring lanes on neighbouring channels, so the
// tile's reads meet no bank conflict), else one value a lane, neighbouring
// lanes on neighbouring pixels. Pixels outside the map are not stored.
__device__ __forceinline__ void store_nchw(const __nv_bfloat16* tile, int nco,
                                           __nv_bfloat16* dst, int H, int W,
                                           int th, int tw, int ty0, int tx0) {
  const int64_t hw = (int64_t)H * W;
  const int bm = th * tw;
  const unsigned short* t16 = reinterpret_cast<const unsigned short*>(tile);
  if (W % 8 == 0 && tw % 8 == 0) {
    const int vecs = bm / 8;
    for (int i = threadIdx.x; i < nco * vecs; i += kThreads) {
      const int c = i % nco, mv = 8 * (i / nco);
      const int gy = ty0 + mv / tw, gx = tx0 + mv % tw;
      if (gy >= H || gx >= W) continue;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = (uint32_t)t16[(mv + 2 * j) * kX1Ld + c] |
               ((uint32_t)t16[(mv + 2 * j + 1) * kX1Ld + c] << 16);
      *reinterpret_cast<uint4*>(dst + c * hw + gy * W + gx) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  for (int i = threadIdx.x; i < nco * bm; i += kThreads) {
    const int c = i / bm, m = i - c * bm;
    const int gy = ty0 + m / tw, gx = tx0 + m % tw;
    if (gy < H && gx < W)
      reinterpret_cast<unsigned short*>(dst)[c * hw + gy * W + gx] =
          t16[m * kX1Ld + c];
  }
}

// The epilogue of a tile stage: bias, ReLU and bf16 for the tile's pixels
// inside the map (the stage's src_h x src_w: a 1x1 or stride-1 3x3 conv
// keeps its input's size), to the concat (NCHW, from channel out_off;
// none when out_off < 0) and, where the stage feeds another, pixel-major
// to st.mid (zero past cout). The values go through a pixel-major tile in
// shared memory (tile, th tw rows of 64 + 8 bf16; every warp is done with
// the staged input), so that both leave in 16-byte vectors: st.mid 8
// channels of a pixel a vector, the concat 8 pixels of a row of one
// channel where the map's width allows it (else one value a lane,
// neighbouring lanes on neighbouring pixels).
template <int MT>
__device__ __forceinline__ void tile_epilogue(const Params& p, const Stage& st,
                                              const Lane& L,
                                              const float (&acc)[MT][4][4],
                                              __nv_bfloat16* tile, int b,
                                              int nb, int ty0, int tx0) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = L.warp_n * 32 + nt * 8 + 2 * (L.lane & 3);
    const float b0 = __ldg(st.bias + nb * kBN + n);
    const float b1 = __ldg(st.bias + nb * kBN + n + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = L.warp_m * 16 * MT + mt * 16 + (L.lane >> 2) + 8 * h;
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(fmaxf(acc[mt][nt][2 * h] + b0, 0.0f));
        v.y = __float2bfloat16_rn(fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(tile + m * kX1Ld + n) = v;
      }
    }
  }
  __syncthreads();
  const int H = st.src_h, W = st.src_w, bm = st.th * st.tw;
  const int64_t hw = (int64_t)H * W;
  if (st.mid != nullptr) {
    const int vecs = min(kBN, st.mid_c - nb * kBN) / 8;
    for (int i = threadIdx.x; i < bm * vecs; i += kThreads) {
      const int m = i / vecs, v = i - m * vecs;
      const int gy = ty0 + m / st.tw, gx = tx0 + m % st.tw;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(st.mid + ((int64_t)b * hw + gy * W + gx) *
                                               st.mid_c + nb * kBN + 8 * v) =
            *reinterpret_cast<const uint4*>(tile + m * kX1Ld + 8 * v);
    }
  }
  if (st.out_off >= 0)
    store_nchw(tile, min(kBN, st.cout - nb * kBN),
               p.out + ((int64_t)b * p.ctot + st.out_off + nb * kBN) * hw, H,
               W, st.th, st.tw, ty0, tx0);
  __syncthreads();
}

// All items of a 1x1 or 3x3 stage. An item is (image, th x tw output tile,
// block of 64 output channels); the grid walks the items in a fixed order,
// so every output comes from one item and one order of sums. The input
// streams in chunks of kc channels into two buffers, chunk kc + 1's copies
// in flight while chunk kc's taps run: a 3x3 stage's pixel-major source
// (and its one-pixel halo) by cp.async; the entry's NCHW x channel-major,
// by cp.async where it is aligned, else by plain loads.
template <int MT>
__device__ void tile_stage(const Params& p, const Stage& st, Ring& ring,
                           unsigned char* smem) {
  const Lane L;
  const bool nhwc = st.taps == 9;
  const bool async = nhwc || (st.src_w % 8 == 0 && st.tw % 8 == 0);
  const int halo = nhwc ? 1 : 0;
  const int rw = st.tw + 2 * halo, rows = (st.th + 2 * halo) * rw;
  const int ld = (st.kc + 8) * 2;  // bytes a row, of act and of a slice
  const int slice_bytes = kBN * ld;
  const int64_t plane = (int64_t)st.src_h * st.src_w;
  unsigned char* const buf[2] = {smem + p.off_act,
                                 smem + p.off_act + st.buf_bytes};
  // the lane's ldmatrix row: pixel-major, its output pixel's place in the
  // region (plus a tap's shift); channel-major, channel tk at pixel mb + tm
  int base[MT];
  const int ldm = st.th * st.tw + 8;
  const int lane = L.lane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int mb = L.warp_m * 16 * MT + mt * 16;
    if (nhwc) {
      const int m = mb + (lane & 7) + 8 * ((lane >> 3) & 1);
      base[mt] = ((m / st.tw) * rw + m % st.tw) * ld + 16 * (lane >> 4);
    } else {
      base[mt] = (((lane & 7) + 8 * (lane >> 4)) * ldm + mb +
                  8 * ((lane >> 3) & 1)) * 2;
    }
  }
  const int astep = nhwc ? 32 : 32 * ldm;
  const int group = nhwc ? 1 : min(2, st.nk);
  const int steps = (st.nk + group - 1) / group;
  for (int item = blockIdx.x; item < st.items; item += gridDim.x) {
    int t = item;
    const int nb = t % st.nblk; t /= st.nblk;
    const int tx = t % st.tiles_x; t /= st.tiles_x;
    const int ty = t % st.tiles_y;
    const int b = t / st.tiles_y;
    const int ty0 = ty * st.th, tx0 = tx * st.tw;
    ring.begin(reinterpret_cast<const char*>(st.w) +
                   (size_t)nb * st.nk * st.taps * slice_bytes,
               slice_bytes, st.nk * st.taps);
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const __nv_bfloat16* img = st.src + (int64_t)b * st.src_c * plane;
    // a step stages `group` chunks (the entry takes two a step, so that
    // each wait and barrier serves two slices; a 3x3 chunk has nine)
    auto stage = [&](int step) {
      unsigned char* dst = buf[step & 1];
      const int c0 = step * group * st.kc;
      if (nhwc)
        stage_nhwc(smem_addr(dst), img, st.src_c, st.src_h, st.src_w, c0,
                   st.kc, rows, ty0 - 1, tx0 - 1, rw);
      else
        stage_nchw(smem_addr(dst), reinterpret_cast<__nv_bfloat16*>(dst),
                   async, img + (int64_t)c0 * plane, plane, st.src_h,
                   st.src_w, st.cin - c0, group * st.kc, st.th, st.tw, ty0,
                   tx0);
    };
    if (async) stage(0);
    cp_async_commit();
    for (int step = 0; step < steps; ++step) {
      if (!async) {
        stage(step);
      } else if (step + 1 < steps) {
        stage(step + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t a = smem_addr(buf[step & 1]);
      const int slices = nhwc ? 9 : min(group, st.nk - step * group);
      for (int s = 0; s < slices; ++s) {
        const uint32_t wslot = ring.wait();
        // a 3x3 tap shifts the rows; the entry's second chunk is the
        // next kc channel rows
        const int shift = nhwc ? ((s / 3) * rw + s % 3) * ld
                               : s * st.kc * ldm * 2;
        int aoff[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) aoff[mt] = base[mt] + shift;
        if (nhwc)
          mma_slice<MT, false>(acc, a, aoff, astep, wslot, ld, st.kc / 16,
                               L.brow, L.bkofs);
        else
          mma_slice<MT, true>(acc, a, aoff, astep, wslot, ld, st.kc / 16,
                              L.brow, L.bkofs);
        ring.release();
      }
    }
    tile_epilogue<MT>(p, st, L, acc,
                      reinterpret_cast<__nv_bfloat16*>(smem + p.off_act), b,
                      nb, ty0, tx0);
  }
}

// The stride-2 front after the entry conv: x1 (full resolution, pixel-major
// in st[0].mid, 64-channel blocks) -> the depthwise avd conv (to st[1].src,
// pixel-major, x2's source) and the 3x3 average pool (to the concat's first
// h1 channels), on CUDA cores in fp32. An item is (image, th x tw tile at
// half resolution, 64 channels): its (2 th + 1) x (2 tw + 1) x1 pixels
// arrive by cp.async, then a warp takes an output pixel, a lane two
// channels (neighbouring lanes on neighbouring words of shared memory),
// into two pixel-major tiles in shared memory, avd and pool, which leave
// in 16-byte vectors: avd 8 channels of a pixel a vector, the pool as the
// tile stages' epilogue writes the concat.
__device__ void avd_pool(const Params& p, unsigned char* smem) {
  const Stage& e = p.st[0];
  const Stage& x2 = p.st[1];
  __nv_bfloat16* x1 = reinterpret_cast<__nv_bfloat16*>(smem + p.off_act);
  const uint32_t x1_s = smem_addr(x1);
  const int th = p.dw_th, tw = p.dw_tw;
  const int rw = 2 * tw + 1, npx = (2 * th + 1) * rw;
  const int n_out = th * tw;
  __nv_bfloat16* avd = x1 + npx * kX1Ld;
  __nv_bfloat16* pool = avd + n_out * kX1Ld;
  const int h1 = e.cout, nblk = e.nblk;
  const int H = p.Ho, W = p.Wo;
  const int64_t hw = (int64_t)H * W;
  const int pair = threadIdx.x & 31;
  for (int item = blockIdx.x; item < p.dw_items; item += gridDim.x) {
    int t = item;
    const int nb = t % nblk; t /= nblk;
    const int tx = t % p.dw_tiles_x; t /= p.dw_tiles_x;
    const int ty = t % p.dw_tiles_y;
    const int b = t / p.dw_tiles_y;
    const int ty0 = ty * th, tx0 = tx * tw;
    const int fy0 = 2 * ty0 - 1, fx0 = 2 * tx0 - 1;
    const __nv_bfloat16* img = e.mid + (int64_t)b * e.src_h * e.src_w * e.mid_c;
    for (int i = threadIdx.x; i < npx * 8; i += kThreads) {
      const int q = i >> 3, v = i & 7;
      const int pr = q / rw, gy = fy0 + pr, gx = fx0 + q - pr * rw;
      const bool ok = gy >= 0 && gy < e.src_h && gx >= 0 && gx < e.src_w;
      const __nv_bfloat16* s =
          ok ? img + ((int64_t)gy * e.src_w + gx) * e.mid_c + nb * kBN + 8 * v
             : img;
      cp_async16(x1_s + (uint32_t)((q * kX1Ld + 8 * v) * 2), s, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int ch = nb * kBN + 2 * pair;
    const bool two = ch + 1 < h1;
    float w0[9], w1[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      w0[k] = ch < h1 ? __ldg(p.avd_w + ch * 9 + k) : 0.0f;
      w1[k] = two ? __ldg(p.avd_w + (ch + 1) * 9 + k) : 0.0f;
    }
    const float bias0 = ch < h1 ? __ldg(p.avd_b + ch) : 0.0f;
    const float bias1 = two ? __ldg(p.avd_b + ch + 1) : 0.0f;
    for (int o = threadIdx.x >> 5; o < n_out; o += kThreads / 32) {
      const int r = o / tw, c = o - r * tw;
      float avd0 = 0.0f, avd1 = 0.0f, pool0 = 0.0f, pool1 = 0.0f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              x1 + ((2 * r + kh) * rw + 2 * c + kw) * kX1Ld + 2 * pair);
          const float v0 = __bfloat162float(v.x), v1 = __bfloat162float(v.y);
          avd0 = fmaf(v0, w0[kh * 3 + kw], avd0);
          avd1 = fmaf(v1, w1[kh * 3 + kw], avd1);
          pool0 += v0;
          pool1 += v1;
        }
      }
      // zero past h1: x2's source is zero-padded to its chunks
      __nv_bfloat162 a2, p2;
      a2.x = __float2bfloat16_rn(ch < h1 ? avd0 + bias0 : 0.0f);
      a2.y = __float2bfloat16_rn(two ? avd1 + bias1 : 0.0f);
      p2.x = __float2bfloat16_rn(pool0 * (1.0f / 9.0f));
      p2.y = __float2bfloat16_rn(pool1 * (1.0f / 9.0f));
      *reinterpret_cast<__nv_bfloat162*>(avd + o * kX1Ld + 2 * pair) = a2;
      *reinterpret_cast<__nv_bfloat162*>(pool + o * kX1Ld + 2 * pair) = p2;
    }
    __syncthreads();
    const int vecs = min(kBN, x2.src_c - nb * kBN) / 8;
    for (int i = threadIdx.x; i < n_out * vecs; i += kThreads) {
      const int o = i / vecs, v = i - o * vecs;
      const int r = o / tw, gy = ty0 + r, gx = tx0 + o - r * tw;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(
            const_cast<__nv_bfloat16*>(x2.src) +
            ((int64_t)b * hw + gy * W + gx) * x2.src_c + nb * kBN + 8 * v) =
            *reinterpret_cast<const uint4*>(avd + o * kX1Ld + 8 * v);
    }
    store_nchw(pool, min(kBN, h1 - nb * kBN),
               p.out + ((int64_t)b * p.ctot + nb * kBN) * hw, H, W, th, tw,
               ty0, tx0);
    __syncthreads();
  }
}

__device__ __forceinline__ void run_tile_stage(const Params& p, const Stage& st,
                                               Ring& ring, unsigned char* smem) {
  if (st.mt == 4)
    tile_stage<4>(p, st, ring, smem);
  else
    tile_stage<2>(p, st, ring, smem);
}

// One launch, stages separated by grid barriers: the entry conv (x1), at
// stride 2 the avd conv and pool, then x2, x3 and x4. A stage reads what
// the one before wrote to device memory (pixel-major intermediates beside
// the concat), so no block recomputes a neighbour's halo.
template <int S>
__global__ void __launch_bounds__(kThreads, 3) fused_cat_tc_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  ring.bars = smem_addr(smem);
  ring.slots = ring.bars + 128;
  ring.head = ring.tail = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) mbar_init(ring.bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  unsigned int barriers = 0;
  run_tile_stage(p, p.st[0], ring, smem);
  if (S == 2) {
    grid_sync(p.bar, ++barriers * gridDim.x);
    avd_pool(p, smem);
  }
  for (int k = 1; k < 4; ++k) {
    grid_sync(p.bar, ++barriers * gridDim.x);
    run_tile_stage(p, p.st[k], ring, smem);
  }
}

template <int S>
int launch_tc(const Params& params, int grid, int smem, cudaStream_t stream) {
  void (*kernel)(Params) = fused_cat_tc_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p = params;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int S>
int resident(int smem) {
  void (*kernel)(Params) = fused_cat_tc_kernel<S>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc

// The bf16 bottleneck: params as the wrapper packed them (tc::Params), a
// grid of `grid` blocks (all resident: a cooperative launch refuses more).
extern "C" int fused_cat_bf16(const void* params, int stride, int grid,
                              int smem, void* stream) {
  const tc::Params& p = *static_cast<const tc::Params*>(params);
  return stride == 2 ? tc::launch_tc<2>(p, grid, smem, (cudaStream_t)stream)
                     : tc::launch_tc<1>(p, grid, smem, (cudaStream_t)stream);
}

// Blocks of the bf16 kernel one SM holds at `smem` bytes (-1 on error).
extern "C" int fused_cat_bf16_blocks_per_sm(int stride, int smem) {
  return stride == 2 ? tc::resident<2>(smem) : tc::resident<1>(smem);
}

// The size of tc::Params, which the wrapper checks its own layout against.
extern "C" int fused_cat_bf16_params_size() { return (int)sizeof(tc::Params); }

#define FUSED_CAT(NAME, T, S)                                                  \
  extern "C" int NAME(const void* x, void* out, const void* w1,               \
                      const void* b1, const void* k2, const void* b2,         \
                      const void* k3, const void* b3, const void* k4,         \
                      const void* b4, const void* avd, const void* avd_b,     \
                      int B, int cin, int H, int W, int h1, int h2, int h3,   \
                      int h4, int Ho, int Wo, int th, int tw, int chunk,      \
                      int off_b, int smem, void* stream) {                    \
    return launch<T, S>(x, out, w1, b1, k2, b2, k3, b3, k4, b4, avd, avd_b,  \
                        B, cin, H, W, h1, h2, h3, h4, Ho, Wo, th, tw, chunk,  \
                        off_b, smem, stream);                                 \
  }

FUSED_CAT(fused_cat_s1_f32, float, 1)
FUSED_CAT(fused_cat_s2_f32, float, 2)
