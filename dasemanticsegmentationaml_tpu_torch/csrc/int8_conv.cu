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
// integer (|acc| <= 127^2 * 9 * 1024 < 2^28) in any order of K and any
// split of K between blocks, so the plain PyTorch version
// (ops/cuda/int8_conv.py::int8_conv_reference: the conv of the int8 values
// in float64, which sums integers exactly, then a separate multiply and
// add) gives the same bits. A NaN input quantizes to 0 (cvt.rni), +-inf to
// +-127.
//
// Two launches a call, planned by ops/cuda/int8_conv.py::plan, a pure
// function of the shape and the SM count:
//
// 1. The prologue quantizes each input value once. int8_conv_quantize_kernel
//    (Cin >= 16) reads the NCHW bf16 / fp32 activations a tile of 128
//    pixels x 32 channels at a time (neighbouring threads on neighbouring
//    pixels, 4 a thread), transposes them through shared memory and writes
//    a scratch NHWC int8 tensor with the channels zero-padded to a multiple
//    of 16 (16-byte stores, 32 contiguous bytes a pixel).
//    int8_conv_im2col_kernel (small Cin: the stem, Cin = 3) writes the
//    im2col rows instead, K = (kh, kw, ci) zero-padded to a multiple of 16,
//    so that the GEMM sees a 1x1 conv over the output grid (NHWC padding of
//    3 channels to 16 would write 5x the stem's input). The prologue also
//    zeroes the split-K tile counters.
// 2. int8_conv_gemm_kernel: a block of two warpgroups owns a 128-pixel x
//    BN-channel tile (BN = 128, 64 or 32 by Cout) and walks K = taps x
//    channels in stages of 64 bytes. For a given (tap, 16-channel piece) a
//    pixel's slice of A is 16 contiguous bytes of the scratch, so every A
//    and B load is one 16-byte cp.async (zero-filled, src-size 0, for taps
//    outside the image, pixels past M, output channels past Cout and K past
//    the taps: the reference pads the quantized input with zeros, so
//    zero-fill is exact). A ring of five stages (fewer where K has fewer),
//    one __syncthreads a stage: the loads run three stages ahead, and one
//    stage's wgmma group stays in flight past the next barrier. Rows of 64
//    bytes are XOR-swizzled by 16-byte chunk (chunk ^ (row >> 1) & 3),
//    which is wgmma's 64-byte swizzle: each warpgroup multiplies its 64
//    rows of the stage by all BN rows of B with two
//    wgmma.mma_async.m64nBNk32.s32.s8.s8 straight from shared memory
//    (descriptors, no ldmatrix), BN / 2 s32 accumulators a thread. The epilogue scales, adds the bias, applies ReLU and casts in
//    registers, stages the tile channel-major through shared memory and
//    stores each channel's run of pixels as 16-byte vectors (where H*W
//    allows; element by element else). Where the tiles give fewer than two
//    blocks an SM, K is split across blocks: each split stores its s32
//    partial sums (fragment order, 16-byte coalesced), and the last split
//    of a tile to arrive (a counter per tile) adds the others' and runs the
//    epilogue once, on the finished sum. Grids are persistent, min(items,
//    SMs x resident blocks), sized by the wrapper from
//    ops/cuda/build.py::sm_count and the occupancy reported here; items
//    walk a pixel tile's channel tiles next to each other (they share its A
//    in L2).
//
// Bound on this card, conv_out.conv (3x3, 256 -> 256) on (8, 256, 64, 128)
// bf16: 2 * 65536 * 256 * 2304 = 77.3 G int8 operations at 1979 TOP/s,
// 0.039 ms; the bytes (33.5 MB in, 33.5 MB out, 0.6 MB of weights) take
// 0.020 ms at 3.35 TB/s (the prologue's scratch adds 16.8 MB written and
// read), so operations bound it. The same ring on mma.sync.m16n8k32, with
// 64 x 32 or 64 x 64 warp tiles, stayed slower than cuDNN's bf16 conv at
// this shape; wgmma beats it (PERF.md §6). Measured and not kept, each
// slower: a tile of 128 x 256 (one block an SM at 254 registers, against
// two at 128), the next tile's first stages loaded during this one's
// epilogue (its staging apart from the ring), and a prologue tile of 64
// channels or with the next tile's loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels a tile
constexpr int kBK = 64;       // bytes of K a stage
constexpr int kStages = 5;    // stages in flight
constexpr int kPiece = 16;    // bytes a cp.async; channels come in 16s
constexpr int kQPix = 128;    // the prologue's tile: pixels
constexpr int kQCh = 32;      // and channels
constexpr int kQPitch = 48;   // bytes a pixel row of its staging
constexpr int kQThreads = 256;
constexpr int kColMaxK = 144; // im2col prologue: bytes a row at most (9 x 16)

template <int BN>
struct Tile {
  static constexpr int kThreads = 256;  // two warpgroups, 64 pixels each
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kAIters = kBM * (kBK / kPiece) / kThreads;
  static constexpr int kBIters = (BN * (kBK / kPiece) + kThreads - 1) / kThreads;
  static constexpr int kAcc = BN / 2;   // s32 accumulators a thread
  // resident blocks the registers are planned for
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;
};

template <typename Tout>
__host__ __device__ constexpr int out_pitch() {
  return kBM * (int)sizeof(Tout) + 16;
}

// shared memory of a GEMM block whose ring has `slots` stages (fewer than
// kStages where K has fewer stages): the ring or the epilogue's staging,
// whichever is larger (the split-K flag right after), and room to align the
// ring to the 64-byte swizzle's 512-byte atoms (1024 to be safe)
template <typename Tout, int BN>
__host__ __device__ constexpr int gemm_body(int slots) {
  return slots * Tile<BN>::kStageBytes > BN * out_pitch<Tout>()
             ? slots * Tile<BN>::kStageBytes
             : BN * out_pitch<Tout>();
}
template <typename Tout, int BN>
__host__ __device__ constexpr int gemm_smem(int slots) {
  return gemm_body<Tout, BN>(slots) + 16 + 1024;
}

struct QuantArgs {
  const void* x;           // (batch, cin, h, w), Tin
  int8_t* xq;              // NHWC (batch, h, w, cq * 16) or im2col (m, cq * 16)
  const float* inv_scale;  // () the activations' 1 / scale
  int* counters;           // split-K tile counters to zero, or null
  int ncounters;
  int batch, cin, h, w, cq, vec;
  int ks, stride, pad, out_h, out_w;  // im2col mode
};

struct GemmArgs {
  const int8_t* xq;       // (batch, in_h, in_w, cq * 16) s8
  const int8_t* wq;       // (cout, kpad) s8, K = (kh, kw, channel)
  const float* out_mul;   // (cout,)
  const float* bias;      // (cout,)
  void* out;              // (batch, cout, out_h, out_w), Tout
  int* partial;           // split-K: (tiles, splits, kBM * BN) s32, or null
  int* counters;          // split-K: (tiles,) zeroed by the prologue
  int in_h, in_w, cq, stride, pad, out_h, out_w, cout, m, kpad, ksteps, relu;
  int tiles_m, tiles_n, splits, vec_out;
  int flag;               // byte offset of the split-K flag in shared memory
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

// four neighbouring values of one channel plane (8- or 16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// A shared-memory matrix descriptor of wgmma for a K-major s8 operand in
// the 64-byte swizzle (the layout of swz below, on 512-byte atoms): start
// address, leading byte offset unused (1), 512 bytes between groups of 8
// rows, layout type 2 (64B swizzle).
__device__ __forceinline__ uint64_t desc64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// D (64 x N s32, in registers) += A (64 x 32 s8) * B (N x 32 s8)^T, both
// from shared memory: one warpgroup's wgmma.mma_async.m64nNk32. D's
// fragment: register 4i + j is row 16 warp + lane / 4, column 8i + 2 (lane
// % 4) + j; 4i + 2 + j the same column, 8 rows down.
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "%16, %17, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, "
        "%128, %129, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// byte offset of 16-byte chunk `ch` (0..3) of row `row` of a 64-byte-row
// stage: the chunk XOR-swizzled by bits 1-2 of the row (bits 4-5 of the
// address by bits 7-8: wgmma's 64-byte swizzle), so eight rows of one chunk
// (a cp.async wavefront) hit eight bank groups
__device__ __forceinline__ int swz(int row, int ch) {
  return row * kBK + ((ch ^ ((row >> 1) & 3)) << 4);
}

// ---------------------------------------------------------------------------
// The prologue, NHWC mode: (batch, cin, h, w) Tin -> (batch, h, w, cq*16) s8.
template <typename Tin>
__global__ void __launch_bounds__(kQThreads)
    int8_conv_quantize_kernel(const QuantArgs a) {
  __shared__ __align__(16) uint8_t s[kQPix * kQPitch];
  const int tid = threadIdx.x;
  for (int i = blockIdx.x * kQThreads + tid; i < a.ncounters;
       i += gridDim.x * kQThreads)
    a.counters[i] = 0;
  const Tin* x = static_cast<const Tin*>(a.x);
  const float inv = *a.inv_scale;
  const int hw = a.h * a.w, cp = a.cq * kPiece;
  const int tiles_p = (hw + kQPix - 1) / kQPix;
  const int tiles_c = (cp + kQCh - 1) / kQCh;
  const int ntiles = a.batch * tiles_p * tiles_c;
  // loads: channel c of the tile, pixels 4q .. 4q+3 (+32 j)
  const int c = tid >> 3, q = tid & 7;
  // stores: half hh of pixel pw's 32 bytes
  const int pw = tid >> 1, hh = tid & 1;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tc = tile % tiles_c, rest = tile / tiles_c;
    const int tp = rest % tiles_p, img = rest / tiles_p;
    const int p0 = tp * kQPix, c0 = tc * kQCh;
    const int ci = c0 + c;
    const Tin* src = x + ((size_t)img * a.cin + ci) * hw + p0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * q + 32 * j;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      bool ok[4] = {false, false, false, false};
      if (ci < a.cin) {
        if (a.vec && p0 + p < hw) {
          load4(src + p, v);
          ok[0] = ok[1] = ok[2] = ok[3] = true;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p0 + p + e < hw) {
              v[e] = to_float(src[p + e]);
              ok[e] = true;
            }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[(p + e) * kQPitch + c] = ok[e] ? (uint8_t)quant(v[e], inv) : 0;
    }
    __syncthreads();
    if (p0 + pw < hw && c0 + 16 * hh < cp)
      *reinterpret_cast<uint4*>(a.xq + ((size_t)img * hw + p0 + pw) * cp +
                                c0 + 16 * hh) =
          *reinterpret_cast<const uint4*>(s + pw * kQPitch + 16 * hh);
    __syncthreads();
  }
}

// The prologue, im2col mode (small Cin): (batch, cin, h, w) Tin -> (m,
// cq*16) s8 rows, K = (kh, kw, ci) zero-padded, one output pixel a thread.
// A channel's KS x KS taps are unrolled, so their loads are in flight
// together; each value lands as one byte of its row in shared memory (a
// pitch of an odd number of words), and the rows leave as coalesced words.
template <typename Tin, int KS>
__global__ void __launch_bounds__(kQThreads)
    int8_conv_im2col_kernel(const QuantArgs a) {
  __shared__ uint32_t s[kQThreads * (kColMaxK / 4 + 1)];
  const int tid = threadIdx.x;
  for (int i = blockIdx.x * kQThreads + tid; i < a.ncounters;
       i += gridDim.x * kQThreads)
    a.counters[i] = 0;
  const Tin* x = static_cast<const Tin*>(a.x);
  const float inv = *a.inv_scale;
  const int hw_in = a.h * a.w, hw_out = a.out_h * a.out_w;
  const int m_total = a.batch * hw_out;
  const int words = a.cq * (kPiece / 4);  // words a row
  const int pitch = words + 1;
  const int k_used = KS * KS * a.cin;
  const int ntiles = (m_total + kQThreads - 1) / kQThreads;
  uint8_t* row = reinterpret_cast<uint8_t*>(s + tid * pitch);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile * kQThreads, m = m0 + tid;
    if (m < m_total) {
      const int img = m / hw_out, p = m - img * hw_out;
      const int oh = p / a.out_w, ow = p - oh * a.out_w;
      const int ih0 = oh * a.stride - a.pad, iw0 = ow * a.stride - a.pad;
      const Tin* xb = x + (size_t)img * a.cin * hw_in + ih0 * a.w + iw0;
      for (int ci = 0; ci < a.cin; ++ci) {
        const Tin* xc = xb + ci * hw_in;
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
          for (int kw = 0; kw < KS; ++kw) {
            const bool ok = (unsigned)(ih0 + kh) < (unsigned)a.h &&
                            (unsigned)(iw0 + kw) < (unsigned)a.w;
            row[(kh * KS + kw) * a.cin + ci] =
                ok ? (uint8_t)quant(to_float(xc[kh * a.w + kw]), inv) : 0;
          }
        }
      }
      for (int k = k_used; k < words * 4; ++k) row[k] = 0;
    } else {
      for (int k = 0; k < words * 4; ++k) row[k] = 0;
    }
    __syncthreads();
    const int nwords = min(kQThreads, m_total - m0) * words;
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.xq) + (size_t)m0 * words;
    for (int i = tid; i < nwords; i += kQThreads) {
      const int r = i / words;
      dst[i] = s[r * pitch + (i - r * words)];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The GEMM over the quantized input.
template <typename Tout, int KS, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads, Tile<BN>::kMinBlocks)
    int8_conv_gemm_kernel(const GemmArgs a) {
  using T = Tile<BN>;
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // accumulator fragment
  const int wg = warp >> 2;                  // the warpgroup: 64 pixels
  const int cp = a.cq * kPiece;
  const int hw_out = a.out_h * a.out_w;
  const int items = a.tiles_m * a.tiles_n * a.splits;
  // the ring on 1024-byte boundaries (wgmma's swizzle atoms), the split-K
  // flag after the larger of the ring and the epilogue's staging
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_addr(smem);
  int* s_last = reinterpret_cast<int*>(smem + a.flag);
  // the loaders: chunk ch of rows (tid >> 2) + kThreads / 4 * i
  const int ch = tid & 3, lrow = tid >> 2;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / a.splits, split = item - tile * a.splits;
    const int tm = tile / a.tiles_n, tn = tile - tm * a.tiles_n;
    const int m0 = tm * kBM, n0 = tn * BN;
    const int s_begin = (int)((long long)split * a.ksteps / a.splits);
    const int s_end = (int)((long long)(split + 1) * a.ksteps / a.splits);
    const int nst = s_end - s_begin;

    // each loader row's pixel: its offset in xq at tap (0, 0) and corner
    int rbase[T::kAIters], rih[T::kAIters], riw[T::kAIters];
#pragma unroll
    for (int i = 0; i < T::kAIters; ++i) {
      const int m = m0 + lrow + (kThreads / 4) * i;
      if (m < a.m) {
        const int img = m / hw_out, p = m - img * hw_out;
        const int oh = p / a.out_w, ow = p - oh * a.out_w;
        rih[i] = oh * a.stride - a.pad;
        riw[i] = ow * a.stride - a.pad;
        rbase[i] = ((img * a.in_h + rih[i]) * a.in_w + riw[i]) * cp;
      } else {
        rih[i] = -(1 << 20);  // never inside the image: zero-filled
        riw[i] = 0;
        rbase[i] = 0;
      }
    }
    // the next stage's K piece j = s * 4 + ch as (tap, 16-channel piece)
    int tap, c16;
    {
      const int j = s_begin * (kBK / kPiece) + ch;
      tap = j / a.cq;
      c16 = j - tap * a.cq;
    }
    int next_stage = s_begin;

    auto load_stage = [&](int slot) {
      const uint32_t sa = sbase + slot * T::kStageBytes;
      const uint32_t sb = sa + kBM * kBK;
      const int kh = tap / KS, kw = tap - (tap / KS) * KS;
      const bool tap_ok = tap < KS * KS;
      const int koff = (kh * a.in_w + kw) * cp + c16 * kPiece;
#pragma unroll
      for (int i = 0; i < T::kAIters; ++i) {
        const int row = lrow + (kThreads / 4) * i;
        const bool ok = tap_ok && (unsigned)(rih[i] + kh) < (unsigned)a.in_h &&
                        (unsigned)(riw[i] + kw) < (unsigned)a.in_w;
        const int8_t* src = ok ? a.xq + rbase[i] + koff : a.xq;
        cp_async16(sa + swz(row, ch), src, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < T::kBIters; ++i) {
        const int row = lrow + (kThreads / 4) * i;
        if (row < BN) {
          const int n = n0 + row;
          const bool ok = n < a.cout;
          const int8_t* src =
              ok ? a.wq + (size_t)n * a.kpad + next_stage * kBK + ch * kPiece
                 : a.wq;
          cp_async16(sb + swz(row, ch), src, ok ? 16 : 0);
        }
      }
      ++next_stage;
      c16 += kBK / kPiece;
      while (c16 >= a.cq) {
        c16 -= a.cq;
        ++tap;
      }
    };

    int acc[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;

    // loads run kAhead stages ahead of the wgmma; one wgmma group stays in
    // flight past its stage's barrier
    constexpr int kAhead = kStages - 2;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < nst) load_stage(i);
      cp_async_commit();
    }
    for (int s = 0; s < nst; ++s) {
      // stage s has landed: this thread's copies, made visible to wgmma's
      // (async) proxy, then everyone's; every warpgroup has also finished
      // the wgmma of stage s - 2, whose slot the next load takes
      cp_async_wait<kAhead - 1>();
      fence_proxy_async();
      __syncthreads();
      if (s + kAhead < nst) load_stage((s + kAhead) % kStages);
      cp_async_commit();
      const uint32_t sa = sbase + (s % kStages) * T::kStageBytes;
      const uint32_t sb = sa + kBM * kBK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        Wgmma<BN>::mma(acc, desc64(sa + wg * 64 * kBK + kk * 32),
                       desc64(sb + kk * 32));
      wgmma_commit();
      wgmma_wait1();
    }
    wgmma_wait0();
    cp_async_wait<0>();
    __syncthreads();

    if (a.splits > 1) {
      // this split's partial sums, in fragment order: 16 bytes a thread
      // and 8 columns, neighbouring threads on neighbouring 16 bytes
      int4* mine = reinterpret_cast<int4*>(a.partial) +
                   (size_t)(tile * a.splits + split) * (kBM * BN / 4);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        mine[i * kThreads + tid] = make_int4(acc[4 * i], acc[4 * i + 1],
                                             acc[4 * i + 2], acc[4 * i + 3]);
      __threadfence();
      __syncthreads();
      if (tid == 0) *s_last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
      __syncthreads();
      const bool last = *s_last;
      __syncthreads();
      if (!last) continue;
      __threadfence();
      for (int o = 0; o < a.splits; ++o) {
        if (o == split) continue;
        const int4* theirs = reinterpret_cast<const int4*>(a.partial) +
                             (size_t)(tile * a.splits + o) * (kBM * BN / 4);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int4 v = __ldcg(theirs + i * kThreads + tid);
          acc[4 * i] += v.x;
          acc[4 * i + 1] += v.y;
          acc[4 * i + 2] += v.z;
          acc[4 * i + 3] += v.w;
        }
      }
    }

    // epilogue in registers, staged channel-major in shared memory
    constexpr int P = out_pitch<Tout>() / (int)sizeof(Tout);
    Tout* so = reinterpret_cast<Tout*>(smem);
    const int ml0 = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nl = i * 8 + 2 * t + e;
        const int co = n0 + nl;
        if (co >= a.cout) continue;
        const float mul = a.out_mul[co], b = a.bias[co];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float y = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * i + 2 * half + e]), mul), b);
          if (a.relu && y < 0.f) y = 0.f;
          store(so + nl * P + ml0 + 8 * half, y);
        }
      }
    }
    __syncthreads();
    if (a.vec_out) {
      constexpr int V = 16 / (int)sizeof(Tout);  // pixels a 16-byte store
      constexpr int VR = kBM / V;
      for (int v = tid; v < BN * VR; v += kThreads) {
        const int nl = v / VR, col = v - nl * VR;
        const int co = n0 + nl, m = m0 + col * V;
        if (co < a.cout && m < a.m) {
          const int img = m / hw_out, p = m - img * hw_out;
          *reinterpret_cast<uint4*>(static_cast<Tout*>(a.out) +
                                    ((size_t)img * a.cout + co) * hw_out + p) =
              *reinterpret_cast<const uint4*>(so + nl * P + col * V);
        }
      }
    } else {
      for (int v = tid; v < BN * kBM; v += kThreads) {
        const int nl = v / kBM, ml = v - nl * kBM;
        const int co = n0 + nl, m = m0 + ml;
        if (co < a.cout && m < a.m) {
          const int img = m / hw_out, p = m - img * hw_out;
          static_cast<Tout*>(a.out)[((size_t)img * a.cout + co) * hw_out + p] =
              so[nl * P + ml];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__host__ __device__ constexpr int is_bf16() {
  return sizeof(T) == 2;
}

// every GEMM instance: (output type, kernel size, tile width)
#define GEMM_CASES(X)                                                      \
  X(float, 1, 32) X(float, 1, 64) X(float, 1, 128) X(float, 3, 32)         \
  X(float, 3, 64) X(float, 3, 128) X(__nv_bfloat16, 1, 32)                 \
  X(__nv_bfloat16, 1, 64) X(__nv_bfloat16, 1, 128)                         \
  X(__nv_bfloat16, 3, 32) X(__nv_bfloat16, 3, 64)                          \
  X(__nv_bfloat16, 3, 128)

// every prologue instance's input type
#define QUANT_CASES(X) X(float) X(__nv_bfloat16)

}  // namespace

// The geometry the wrapper must share, read by it once at load.
extern "C" int int8_conv_tile_m() { return kBM; }
extern "C" int int8_conv_tile_k() { return kBK; }
extern "C" int int8_conv_piece() { return kPiece; }
extern "C" int int8_conv_stages() { return kStages; }
extern "C" int int8_conv_im2col_max_k() { return kColMaxK; }
extern "C" int int8_conv_quantize_pixels() { return kQPix; }
extern "C" int int8_conv_quantize_channels() { return kQCh; }
extern "C" int int8_conv_im2col_pixels() { return kQThreads; }

// Resident blocks an SM holds of one GEMM instance (0 for one that does
// not exist, or when the card refuses its shared memory): the wrapper
// sizes the grid with it. Sets the instance's dynamic shared memory limit
// on the current device, so call it once per device before a launch.
extern "C" int int8_conv_gemm_blocks_per_sm(int out_bf16, int ks, int bn,
                                            int slots) {
#define X(TO, KS_, BN_)                                                     \
  if (out_bf16 == is_bf16<TO>() && ks == KS_ && bn == BN_) {                \
    if (slots < 1 || slots > kStages) return 0;                             \
    if (cudaFuncSetAttribute(int8_conv_gemm_kernel<TO, KS_, BN_>,           \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             gemm_smem<TO, BN_>(kStages)) != cudaSuccess)   \
      return 0;                                                             \
    int n = 0;                                                              \
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(                      \
            &n, int8_conv_gemm_kernel<TO, KS_, BN_>, Tile<BN_>::kThreads,   \
            gemm_smem<TO, BN_>(slots)) != cudaSuccess)                      \
      return 0;                                                             \
    return n;                                                               \
  }
  GEMM_CASES(X)
#undef X
  return 0;
}

extern "C" int int8_conv_quantize_blocks_per_sm(int in_bf16, int im2col,
                                                int ks) {
#define X(TI)                                                               \
  if (in_bf16 == is_bf16<TI>()) {                                           \
    int n = 0;                                                              \
    cudaError_t err;                                                        \
    if (im2col && ks == 3)                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
          &n, int8_conv_im2col_kernel<TI, 3>, kQThreads, 0);                \
    else if (im2col)                                                        \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
          &n, int8_conv_im2col_kernel<TI, 1>, kQThreads, 0);                \
    else                                                                    \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
          &n, int8_conv_quantize_kernel<TI>, kQThreads, 0);                 \
    return err == cudaSuccess ? n : 0;                                      \
  }
  QUANT_CASES(X)
#undef X
  return 0;
}

// The prologue's launch on `stream`; returns the CUDA error of the launch
// (0: none).
extern "C" int int8_conv_quantize(const void* x, void* xq,
                                  const void* inv_scale, void* counters,
                                  int ncounters, int in_bf16, int im2col,
                                  int vec, int batch, int cin, int h, int w,
                                  int cq, int ks, int stride, int pad,
                                  int out_h, int out_w, int grid,
                                  void* stream) {
  QuantArgs a;
  a.x = x;
  a.xq = static_cast<int8_t*>(xq);
  a.inv_scale = static_cast<const float*>(inv_scale);
  a.counters = static_cast<int*>(counters);
  a.ncounters = ncounters;
  a.batch = batch;
  a.cin = cin;
  a.h = h;
  a.w = w;
  a.cq = cq;
  a.vec = vec;
  a.ks = ks;
  a.stride = stride;
  a.pad = pad;
  a.out_h = out_h;
  a.out_w = out_w;
  if (im2col && cq * kPiece > kColMaxK) return (int)cudaErrorInvalidValue;
#define X(TI)                                                               \
  if (in_bf16 == is_bf16<TI>()) {                                           \
    if (im2col && ks == 3)                                                  \
      int8_conv_im2col_kernel<TI, 3>                                        \
          <<<grid, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);   \
    else if (im2col)                                                        \
      int8_conv_im2col_kernel<TI, 1>                                        \
          <<<grid, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);   \
    else                                                                    \
      int8_conv_quantize_kernel<TI>                                         \
          <<<grid, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);   \
    return (int)cudaGetLastError();                                         \
  }
  QUANT_CASES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The GEMM's launch on `stream`; returns the CUDA error of the launch.
extern "C" int int8_conv_gemm(const void* xq, const void* wq,
                              const void* out_mul, const void* bias,
                              void* out, void* partial, void* counters,
                              int out_bf16, int ks, int bn, int in_h, int in_w,
                              int cq, int stride, int pad, int out_h,
                              int out_w, int cout, int m, int kpad, int relu,
                              int tiles_m, int tiles_n, int splits,
                              int vec_out, int grid, void* stream) {
  GemmArgs a;
  a.xq = static_cast<const int8_t*>(xq);
  a.wq = static_cast<const int8_t*>(wq);
  a.out_mul = static_cast<const float*>(out_mul);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.partial = static_cast<int*>(partial);
  a.counters = static_cast<int*>(counters);
  a.in_h = in_h;
  a.in_w = in_w;
  a.cq = cq;
  a.stride = stride;
  a.pad = pad;
  a.out_h = out_h;
  a.out_w = out_w;
  a.cout = cout;
  a.m = m;
  a.kpad = kpad;
  a.ksteps = kpad / kBK;
  a.relu = relu;
  a.tiles_m = tiles_m;
  a.tiles_n = tiles_n;
  a.splits = splits;
  a.vec_out = vec_out;
  // the ring's stages: every stage of K where K has fewer than kStages
  const int slots = a.ksteps < kStages ? a.ksteps : kStages;
  if (kpad % kBK != 0 || splits < 1 || splits > a.ksteps ||
      (splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
#define X(TO, KS_, BN_)                                                     \
  if (out_bf16 == is_bf16<TO>() && ks == KS_ && bn == BN_) {                \
    a.flag = gemm_body<TO, BN_>(slots);                                     \
    int8_conv_gemm_kernel<TO, KS_, BN_>                                     \
        <<<grid, Tile<BN_>::kThreads, gemm_smem<TO, BN_>(slots),            \
           static_cast<cudaStream_t>(stream)>>>(a);                         \
    return (int)cudaGetLastError();                                         \
  }
  GEMM_CASES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}
