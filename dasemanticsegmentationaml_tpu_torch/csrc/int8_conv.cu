// int8 convolution with its fp32 epilogue, as an implicit GEMM on Hopper's
// tensor cores.
//
// No Pallas original: it replaces the XLA ops of the JAX package's
// dasemanticsegmentationaml_tpu/ops/quantize.py::int8_conv_epilogue (:108),
// the body of every conv+BN+ReLU block (ConvX, ConvBNReLU) of an int8 model
// (--quantize_int8). PyTorch has no eager int8 convolution on CUDA, so the
// port needs this kernel by hand.
//
// What it computes, for output pixel (n, oh, ow) and channel co:
//   q(v)  = clamp(rint(v * in_inv_scale), -127, 127)          (s8)
//   acc   = sum over ci, kh, kw of q(x[n, ci, ih, iw]) * w[co, ci, kh, kw]
//           with ih = oh*stride - pad + kh, iw = ow*stride - pad + kw and
//           zero outside the image                            (s32, exact)
//   y     = acc * out_mul[co] + bias[co], then ReLU           (fp32)
//   out   = y in the output's type (fp32, or bf16 rounded to nearest even)
// Each multiply and add is its own round-to-nearest fp32 operation
// (__fmul_rn / __fadd_rn: no FMA contraction), and acc is an exact
// integer (|acc| <= 127^2 * 9 * 1024 < 2^28), so the plain PyTorch
// version (ops/cuda/int8_conv.py::int8_conv_reference: the conv of the
// int8 values in float64, which sums integers exactly, then a separate
// multiply and add) gives the same bits. A NaN input quantizes to 0.
//
// Layout: the activations come NCHW (bf16 or fp32), as the port's model
// hands them over; the output is NCHW. A model in channels_last would hand
// over NHWC, and the caller's .contiguous() then costs a transpose of the
// input (one read and one write of it) before each launch.
//
// Design. GEMM view: M = output pixels (N*Ho*Wo), N = output channels,
// K = Cin*KS*KS. A block owns a 128-pixel x 64-channel tile and walks K in
// stages of 32 (one mma.sync.m16n8k32.s8.s8.s32 deep); eight warps, each a
// 32 x 32 sub-tile (two m16 by four n8 fragments, 32 s32 accumulators a
// thread).
//   * A (activations) is gathered and quantized on the load: each thread
//     owns one pixel of the tile and four 4-byte words (16 K values) of a
//     stage, reads them from the NCHW input (neighbouring lanes on
//     neighbouring pixels: coalesced), multiplies by in_inv_scale, rounds,
//     clamps, packs four s8 into a word and stores it to shared memory. So
//     full-resolution int8 activations never exist in device memory.
//     When Cin is a multiple of 32 (every block of BiSeNet but the stem),
//     K runs tap-major (k = (kh*KS + kw)*Cin + ci): a stage is one tap and
//     32 consecutive channels, so a thread tests its pixel's bounds once a
//     stage and steps by H*W from channel to channel. Otherwise (Cin = 3 at
//     the stem) K runs in PyTorch's OIHW order, zero-padded to a multiple
//     of 32, and each element decodes its (ci, kh, kw) with constant
//     divisions.
//   * B (weights) is packed once by the wrapper (pack_weights) into s8
//     rows of K in the same order, K padded to 32, output channels padded
//     to 64; a stage is one 16-byte load for 128 of the threads.
//   * Two shared-memory buffers: the next stage's loads go out into
//     registers before this stage's MMAs and are stored after them, one
//     barrier a stage. Row pitches of 36 (A) and 48 (B) bytes keep the
//     stores and the fragment loads off shared bank conflicts.
//   * The epilogue runs on the accumulators in registers: scale, bias,
//     ReLU, cast, and a store straight to the NCHW output (eight
//     neighbouring pixels of one channel a quarter-warp).
//   * The grid is min(tiles, SMs x resident blocks), sized by the wrapper
//     from ops/cuda/build.py::sm_count and the occupancy the library
//     reports; each block walks tiles, channel tiles of one pixel tile
//     next to each other (they share its input in L2).
//
// Bound on this card, conv_out.conv (3x3, 256 -> 256) on (8, 256, 64, 128)
// bf16: 2 * 65536 * 256 * 2304 = 77.3 G int8 operations at 1979 TOP/s,
// 0.039 ms; the bytes (33.5 MB in, 33.5 MB out, 0.6 MB of weights) take
// 0.020 ms at 3.35 TB/s, so operations bound it. This first kernel is
// simple: mma.sync rather than wgmma, a gather by the threads rather than
// TMA, and the quantize on every reload of an input value (KS*KS times);
// its time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kBM = 128;       // output pixels a tile
constexpr int kBN = 64;        // output channels a tile
constexpr int kBK = 32;        // K a stage
constexpr int kApitch = 36;    // bytes a row of A in shared memory
constexpr int kBpitch = 48;    // bytes a row of B (16-byte aligned)

struct Args {
  const void* x;          // (batch, cin, in_h, in_w), Tin
  const int8_t* wq;       // (tiles_n * kBN, kp) s8, K in the kernel's order
  const float* out_mul;   // (cout,)
  const float* bias;      // (cout,)
  const float* inv_scale; // () the activations' 1 / scale
  void* out;              // (batch, cout, out_h, out_w), Tout
  int batch, cin, in_h, in_w, cout, out_h, out_w, stride, pad;
  int k, kp, relu, m, tiles_m, tiles_n;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rint(v * inv) clamped to [-127, 127] as one s8 in the low byte: the
// plain version's torch.round (half to even) and clamp. cvt.rni saturates
// +-inf and gives 0 for NaN.
__device__ __forceinline__ uint32_t quant(float v, float inv) {
  int q = __float2int_rn(__fmul_rn(v, inv));
  q = max(-127, min(127, q));
  return (uint32_t)(uint8_t)(int8_t)q;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename Tin, typename Tout, int KS, bool TAP_MAJOR>
__global__ void __launch_bounds__(kThreads, 2)
    int8_conv_kernel(const Args a) {
  __shared__ __align__(16) uint8_t sa[2][kBM * kApitch];
  __shared__ __align__(16) uint8_t sb[2][kBN * kBpitch];
  const Tin* x = static_cast<const Tin*>(a.x);
  Tout* out = static_cast<Tout*>(a.out);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int wm = warp & 3, wn = warp >> 2;    // the warp's 32 x 32 sub-tile
  const float inv = *a.inv_scale;
  const int hw_in = a.in_h * a.in_w, hw_out = a.out_h * a.out_w;
  const int steps = a.kp / kBK;
  // the loader: one pixel row of the tile and words kw0, +2, +4, +6
  const int lrow = tid & (kBM - 1);
  const int kw0 = tid >> 7;
  const int ntiles = a.tiles_m * a.tiles_n;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tn = tile % a.tiles_n, tm = tile / a.tiles_n;
    const int m0 = tm * kBM, n0 = tn * kBN;
    const int pm = m0 + lrow;
    const bool pvalid = pm < a.m;
    int img = 0, oh = 0, ow = 0;
    if (pvalid) {
      img = pm / hw_out;
      const int p = pm - img * hw_out;
      oh = p / a.out_w;
      ow = p - oh * a.out_w;
    }
    const int hi0 = oh * a.stride - a.pad, wi0 = ow * a.stride - a.pad;
    const Tin* xb = x + (size_t)img * a.cin * hw_in;

    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    uint32_t ra[4];
    uint4 rb = make_uint4(0, 0, 0, 0);

    // stage s into registers: A gathered and quantized, B one 16-byte load
    auto load = [&](int s) {
      const int k0 = s * kBK;
      if (TAP_MAJOR) {
        const int tap = k0 / a.cin, ci0 = k0 - tap * a.cin;
        const int kh = tap / KS, kx = tap - kh * KS;
        const int ih = hi0 + kh, iw = wi0 + kx;
        const bool ok = pvalid && ih >= 0 && ih < a.in_h && iw >= 0 &&
                        iw < a.in_w;
        const Tin* px = xb + ih * a.in_w + iw;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = 0;
          if (ok) {
            const Tin* q = px + (ci0 + 4 * (kw0 + 2 * j)) * hw_in;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              word |= quant(to_float(q[e * hw_in]), inv) << (8 * e);
          }
          ra[j] = word;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = k0 + 4 * (kw0 + 2 * j) + e;
            const int ci = k / (KS * KS);
            const int r = k - ci * (KS * KS);
            const int kh = r / KS, kx = r - kh * KS;
            const int ih = hi0 + kh, iw = wi0 + kx;
            if (pvalid && k < a.k && ih >= 0 && ih < a.in_h && iw >= 0 &&
                iw < a.in_w)
              word |= quant(to_float(xb[ci * hw_in + ih * a.in_w + iw]), inv)
                      << (8 * e);
          }
          ra[j] = word;
        }
      }
      if (tid < 2 * kBN)
        rb = *reinterpret_cast<const uint4*>(
            a.wq + (size_t)(n0 + (tid >> 1)) * a.kp + k0 + 16 * (tid & 1));
    };

    auto stash = [&](int buf) {
      uint32_t* A = reinterpret_cast<uint32_t*>(sa[buf]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        A[lrow * (kApitch / 4) + kw0 + 2 * j] = ra[j];
      if (tid < 2 * kBN)
        *reinterpret_cast<uint4*>(sb[buf] + (tid >> 1) * kBpitch +
                                  16 * (tid & 1)) = rb;
    };

    auto compute = [&](int buf) {
      const uint32_t* A = reinterpret_cast<const uint32_t*>(sa[buf]);
      const uint32_t* B = reinterpret_cast<const uint32_t*>(sb[buf]);
      constexpr int ap = kApitch / 4, bp = kBpitch / 4;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = A[r * ap + t];
        af[mi][1] = A[(r + 8) * ap + t];
        af[mi][2] = A[r * ap + 4 + t];
        af[mi][3] = A[(r + 8) * ap + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        bf[ni][0] = B[c * bp + t];
        bf[ni][1] = B[c * bp + 4 + t];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    };

    load(0);
    stash(0);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const bool more = s + 1 < steps;
      if (more) load(s + 1);
      compute(s & 1);
      if (more) stash((s + 1) & 1);
      __syncthreads();
    }

    // epilogue in registers: c0, c1 at row g, columns 2t, 2t+1; c2, c3 at
    // row g + 8
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pm2 = m0 + wm * 32 + mi * 16 + g + 8 * half;
        if (pm2 >= a.m) continue;
        const int img2 = pm2 / hw_out, p2 = pm2 - img2 * hw_out;
        Tout* ob = out + (size_t)img2 * a.cout * hw_out + p2;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = n0 + wn * 32 + ni * 8 + 2 * t + e;
            if (co >= a.cout) continue;
            float y = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + e]),
                          a.out_mul[co]),
                a.bias[co]);
            if (a.relu && y < 0.f) y = 0.f;
            store(ob + (size_t)co * hw_out, y);
          }
        }
      }
    }
  }
}

// every instance: (input type, output type, kernel size, tap-major K)
#define INT8_CONV_CASES(X)                                                 \
  X(float, float, 1, false) X(float, float, 1, true)                       \
  X(float, float, 3, false) X(float, float, 3, true)                       \
  X(float, __nv_bfloat16, 1, false) X(float, __nv_bfloat16, 1, true)       \
  X(float, __nv_bfloat16, 3, false) X(float, __nv_bfloat16, 3, true)       \
  X(__nv_bfloat16, float, 1, false) X(__nv_bfloat16, float, 1, true)       \
  X(__nv_bfloat16, float, 3, false) X(__nv_bfloat16, float, 3, true)       \
  X(__nv_bfloat16, __nv_bfloat16, 1, false)                                \
  X(__nv_bfloat16, __nv_bfloat16, 1, true)                                 \
  X(__nv_bfloat16, __nv_bfloat16, 3, false)                                \
  X(__nv_bfloat16, __nv_bfloat16, 3, true)

template <typename T>
constexpr int is_bf16() {
  return sizeof(T) == 2;
}

}  // namespace

// The geometry the wrapper must share, read by it once at load.
extern "C" int int8_conv_tile_m() { return kBM; }
extern "C" int int8_conv_tile_n() { return kBN; }
extern "C" int int8_conv_tile_k() { return kBK; }

// Resident blocks an SM holds of one instance (0 for an instance that does
// not exist): the wrapper sizes the grid with it.
extern "C" int int8_conv_blocks_per_sm(int in_bf16, int out_bf16, int ks,
                                       int tap_major) {
#define X(TI, TO, KS_, TM)                                                 \
  if (in_bf16 == is_bf16<TI>() && out_bf16 == is_bf16<TO>() && ks == KS_ && \
      (tap_major != 0) == TM) {                                            \
    int n = 0;                                                             \
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
            &n, int8_conv_kernel<TI, TO, KS_, TM>, kThreads, 0) !=         \
        cudaSuccess)                                                       \
      return 0;                                                            \
    return n;                                                              \
  }
  INT8_CONV_CASES(X)
#undef X
  return 0;
}

// One launch on `stream`; returns the CUDA error of the launch (0: none).
extern "C" int int8_conv(const void* x, const void* wq, const void* out_mul,
                         const void* bias, const void* inv_scale, void* out,
                         int in_bf16, int out_bf16, int ks, int tap_major,
                         int batch, int cin, int in_h, int in_w, int cout,
                         int out_h, int out_w, int stride, int pad, int k,
                         int kp, int relu, int tiles_m, int tiles_n, int grid,
                         void* stream) {
  Args a;
  a.x = x;
  a.wq = static_cast<const int8_t*>(wq);
  a.out_mul = static_cast<const float*>(out_mul);
  a.bias = static_cast<const float*>(bias);
  a.inv_scale = static_cast<const float*>(inv_scale);
  a.out = out;
  a.batch = batch;
  a.cin = cin;
  a.in_h = in_h;
  a.in_w = in_w;
  a.cout = cout;
  a.out_h = out_h;
  a.out_w = out_w;
  a.stride = stride;
  a.pad = pad;
  a.k = k;
  a.kp = kp;
  a.relu = relu;
  a.m = batch * out_h * out_w;
  a.tiles_m = tiles_m;
  a.tiles_n = tiles_n;
#define X(TI, TO, KS_, TM)                                                 \
  if (in_bf16 == is_bf16<TI>() && out_bf16 == is_bf16<TO>() && ks == KS_ && \
      (tap_major != 0) == TM) {                                            \
    int8_conv_kernel<TI, TO, KS_, TM>                                      \
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);     \
    return (int)cudaGetLastError();                                        \
  }
  INT8_CONV_CASES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}
