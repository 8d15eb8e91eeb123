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
// Design. One block owns a th x tw tile of output pixels of one image and
// recomputes its halo, so blocks share nothing and run in any order (the
// TPU kernel walks row blocks in order and passes halo rows in through
// three BlockSpecs, :290; its space-to-depth front, :367, and VMEM budget,
// :303, are not ported: on the card a strided or offset load is a plain
// load). The chain x2 <- x3 <- x4 needs 3 extra pixels on each side at
// output resolution:
//   stride 1: x1 over the tile + 3 -> shared buffer A; x2 over the tile + 2
//             -> buffer B; x3 over the tile + 1 -> A (x1 is dead); x4 over
//             the tile -> device memory.
//   stride 2: the avd output over the tile + 3 at half resolution lives in
//             A. x1 is needed at full resolution over 2 (t + 6) + 1 pixels
//             a side; both avd and the pool are depthwise, so x1 is
//             computed `chunk` channels at a time into B, each chunk feeds
//             avd (into A) and the pool (straight to device memory) and is
//             dropped. Then x2 -> B, x3 -> A, x4 -> device memory.
// Every stage writes the tile's own pixels of its output (x1 or the pool,
// x2, x3, x4) to the concat at its channel offset as it goes.
// A stage is an implicit GEMM on CUDA cores: a warp takes 32 * PM output
// pixels (lane-strided, so the shared-memory reads of a warp are
// consecutive) times 8 output channels; each thread keeps PM x 8 fp32 sums
// in registers, reads its PM activations from shared memory (the entry
// conv from device memory) and the 8 weights as two broadcast float4
// loads. The weights are fp32 copies of the T-rounded values, packed
// (Cin * kh * kw, Cout padded to 8) by the wrapper, so no conversion is
// spent on them.
//
// Bound on this card. The six STDC813 bottlenecks at batch 8 and 1024x512
// take about 8.5 GFLOP of useful multiply-adds each (2 FLOP per MAC); the
// recomputed halo adds 1.5-5x that, most at stage 5, where a 512-channel
// x1 leaves room for a 4 x 8 tile only (x1 alone is 2 B x 512 x (t + 6)^2
// at a t x t tile). Plain FMA loops reach a fraction of the 67 TFLOP/s of
// fp32 FMA, so the kernel is bound by FMA issue and shared-memory loads,
// and sits far from cuDNN's tensor-core convolutions. wgmma, TMA, clusters
// sharing a halo, and bf16 tensor-core products are the redesign's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 8;  // output channels per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
FUSED_CAT(fused_cat_s1_bf16, __nv_bfloat16, 1)
FUSED_CAT(fused_cat_s2_f32, float, 2)
FUSED_CAT(fused_cat_s2_bf16, __nv_bfloat16, 2)
