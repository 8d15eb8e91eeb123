// Fused bilinear upsample (align_corners=True) + class argmax for Hopper.
//
// Replaces the Pallas TPU kernel
// dasemanticsegmentationaml_tpu/ops/pallas/upsample_argmax.py
// (upsample_argmax :252, _pallas_call :163, bodies _make_kernel :137 and
// _make_split_kernel :108). Eval inference (reference train.py:36-38) takes
// the main head's logits at stride 8, upsamples them to the input size
// (model_stages.py:240) and takes the class argmax (utils.py:120-122).
// Unfused, the upsampled logits (19 x 512 x 1024 fp32 = 40 MB per image)
// are written to and read back from device memory; here they never leave
// registers.
//
// What it computes, for each output pixel (b, y, x):
//   r_lo = (1-ty) * X[c, lo_y, lo_x] + ty * X[c, hi_y, lo_x]
//   r_hi = (1-ty) * X[c, lo_y, hi_x] + ty * X[c, hi_y, hi_x]
//   u[c] = (1-tx) * r_lo + tx * r_hi
//   out  = torch.argmax over c of u: the first NaN if there is one,
//          otherwise the first c with the largest u[c]
// Rows are interpolated first, then columns, as JAX resize.py:109-112 does.
// The taps (lo, hi, t) are the float64-derived fp32 numbers of
// ops/resize.py::_align_corners_taps, passed in as device arrays.
//
// Numerics: every product and sum is a separate round-to-nearest fp32
// operation (__fmul_rn / __fadd_rn / __fsub_rn, no FMA contraction), so the
// plain PyTorch version (separate multiplies and adds, then torch.argmax)
// gives the same bits, non-finite logits included. bf16 logits are widened
// to fp32 exactly. The TPU kernel's bf16 hi+lo "split" tier and its 1-pass
// "fast" tier existed only because the TPU matrix unit is slow in fp32
// (upsample_argmax.py:26-40); two-tap fp32 arithmetic is exact for both
// input types here, so neither is ported. Any B, C, h, w, H, W >= 1 is
// taken whose element counts fit a 32-bit index (the wrapper checks).
//
// Non-finite logits. A NaN, or an inf (0 * inf is NaN in the formula),
// can only make u[c] NaN where r_lo or r_hi of that class is non-finite:
// from finite r_lo, r_hi each product is finite and their sum is finite
// or +-inf, never NaN. So a segment (below) tests its row pass once
// (r * 0 is 0 for every finite r, NaN otherwise, summed by FMAs); a
// finite segment keeps the plain `u > best` scan, which is torch.argmax's
// rule on values without NaN, and only a segment with a non-finite row
// pass scans with a NaN test: take c while best is not NaN and u is NaN
// or above best.
//
// Design. The work of a pixel is 3 fp32 operations a class for the column
// pass and a compare and two selects for the running argmax; the row pass
// is shared. One thread owns one column segment of one output row: the x
// whose lo column tap is j (contiguous, since the taps are monotone; 8 or
// 9 pixels at 64 x 128 -> 512 x 1024), all of which share the column taps
// j and hi = min(j+1, w-1) (ops/resize.py::tap_ranges). The thread does
// the row pass once per class for its two columns, keeps those 2*C values
// in registers, and each of its pixels does only the column pass and the
// argmax: 4*C loads a segment instead of 4*C a pixel.
//   * One block per band of output rows of one image (rows per band from
//     the work and the card's SM count: ops/cuda/upsample_argmax.py::
//     band_geometry); a thread takes one (row, segment) at a time, lanes
//     of a warp neighbouring segments of one row (coalesced row-pass
//     loads, through L1: neighbours share a column).
//   * Stores. A thread's pixels are 8 apart from its neighbour's: storing
//     them straight to device memory puts a warp's 32 lanes on 32 sectors
//     a store. So the band's labels are staged in shared memory (one pad
//     word every 32, so that 32 lanes 8 words apart hit 32 banks) and then
//     written with coalesced 16-byte stores. A band whose labels exceed
//     48 KB (rows wider than ~11,900 pixels) stores straight to device
//     memory instead.
//   * Classes. A template on C keeps the row pass in registers: an
//     instance for 19, and a generic one that takes the classes in chunks
//     of 32; past the first chunk a pixel's running class is read back
//     from where it was stored and its value recomputed, bit for bit.
//   * 32-bit index arithmetic throughout; one div/mod a segment, none a
//     pixel.
//
// Bound on this card, (8, 19, 64, 128) bf16 -> 8 x 512 x 1024: 16.8 MB of
// int32 labels and 2.5 MB of logits, 0.0058 ms at 3.35 TB/s
// (chip_smoke.py::bound_upsample_argmax). Instruction issue sets a higher
// floor, 0.0178 ms (chip_smoke.py::issue_floor_upsample_argmax): the
// column pass (3 operations), the compare and two selects are about 6
// instructions a pixel and class, 480 M lane-instructions, plus the row
// pass; none is an FMA, so they issue at half the rate that the bound's
// 67 TFLOP/s assumes. Measured on an H100 (PERF.md §6): about 0.038 ms.
// The SASS of <bf16, 19> shows why: 6.4 instructions a pixel and class
// in the pixel loop, whose compare and selects run on the ALU pipe at
// half rate, so issue and that pipe bind together; 433 a segment for the
// row pass (76 loads with their addresses and widening, 57 fp32
// operations, the finite test), about 53 a pixel; a warp runs its
// longest segment (9 pixels where most have 8); and the last of 2.6
// waves of blocks is 0.6 full. Staging the row pass in shared memory, a
// max-first argmax, 4 blocks an SM and per-segment class pruning were
// each measured and were no faster (PERF.md §6).
//
// Registers (-Xptxas -v): 80 at <bf16, 19> and <float, 19>
// (__launch_bounds__(256, 3)), no spills, 3 blocks (24 warps) an SM; the
// generic instance 153 and 150, one block an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block (ops/cuda/upsample_argmax.py::THREADS)
constexpr int kChunk = 32;     // classes a generic chunk keeps in registers

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// (1-t) * a + t * b given w0 = 1-t, each product and the sum rounded apart.
__device__ __forceinline__ float lerp_rn(float w0, float t, float a, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(t, b));
}

// Where a band's label g goes: g + (g >> shift) in the buffer o, with
// o the staging buffer and shift 5 (one pad word every 32), or o the
// band's rows in device memory and shift 31 (g itself).
__device__ __forceinline__ int at(int g, int shift) { return g + (g >> shift); }

// Words of a band of n labels in the staging buffer (stage_bytes / 4 in
// ops/cuda/upsample_argmax.py).
int stage_words(int n) { return n + n / 32 + 1; }

// The running argmax over the classes [c0, c0 + kCap) of one pixel.
// kNaN: torch.argmax's rule where u may be NaN (the first NaN wins, a NaN
// best is kept); otherwise the first of the largest.
template <bool kNaN, int kCap, int NC>
__device__ __forceinline__ void scan(int nc, int c0, float wx0, float wx,
                                     const float (&rl)[kCap],
                                     const float (&rh)[kCap], float& best,
                                     int& arg) {
#pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (NC > 0 || c0 + c < nc) {
      const float u = lerp_rn(wx0, wx, rl[c], rh[c]);
      if (kNaN ? best == best && !(u <= best) : u > best) {
        best = u;
        arg = c0 + c;
      }
    }
  }
}

// One segment's pixels [x0, x1) of the band row starting at label g0:
// the column pass and the argmax over the classes [c0, c0 + kCap), each
// label stored at o[at(g, shift)]. Past the first chunk (generic
// instance, C > 32) a pixel starts from the class stored there, its value
// recomputed from the logits. The body has no branch but that one, so
// consecutive pixels' compare chains interleave.
template <bool kNaN, typename T, int kCap, int NC>
__device__ __forceinline__ void segment(
    int nc, int c0, int x0, int x1, int g0, const float* __restrict__ tx,
    const float (&rl)[kCap], const float (&rh)[kCap], int32_t* o, int shift,
    const T* __restrict__ src, int plane, int row_lo, int row_hi, int j,
    int hi, float wy0, float wy) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll 2
  for (int x = x0; x < x1; ++x) {
    const float wx = __ldg(tx + x), wx0 = __fsub_rn(1.0f, wx);
    const int g = at(g0 + x, shift);
    float best = -inf;
    int arg = 0;
    if (NC == 0 && c0 > 0) {
      arg = o[g];
      const T* s = src + arg * plane;
      best = lerp_rn(wx0, wx,
                     lerp_rn(wy0, wy, load_f32(s + row_lo + j),
                             load_f32(s + row_hi + j)),
                     lerp_rn(wy0, wy, load_f32(s + row_lo + hi),
                             load_f32(s + row_hi + hi)));
    }
    scan<kNaN, kCap, NC>(nc, c0, wx0, wx, rl, rh, best, arg);
    o[g] = arg;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC > 0 ? 3 : 1)
upsample_argmax_band_kernel(
    const T* __restrict__ logits, int32_t* __restrict__ out,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ hi_x,
    const float* __restrict__ tx, const int32_t* __restrict__ xr, int C,
    int h, int w, int H, int W, int rows, int n_bands, int stage) {
  constexpr int kCap = NC > 0 ? NC : kChunk;
  const int nc = NC > 0 ? NC : C;
  extern __shared__ int32_t out_s[];
  const int band = blockIdx.x % n_bands;
  const int b = blockIdx.x / n_bands;
  const int y0 = band * rows;
  const int nr = min(rows, H - y0);
  const int plane = h * w;
  const T* src = logits + b * nc * plane;
  int32_t* dst = out + (b * H + y0) * W;
  int32_t* const o = stage ? out_s : dst;
  const int shift = stage ? 5 : 31;

  for (int item = threadIdx.x; item < nr * w; item += kThreads) {
    const int r = item / w, j = item - r * w;
    const int x0 = __ldg(xr + 4 * j), x1 = __ldg(xr + 4 * j + 1);
    if (x0 == x1) continue;  // downsampling: no output column has lo tap j
    const int hi = __ldg(hi_x + x0);
    const int y = y0 + r;
    const float wy = __ldg(ty + y), wy0 = __fsub_rn(1.0f, wy);
    const int row_lo = __ldg(lo_y + y) * w, row_hi = __ldg(hi_y + y) * w;
    // the four taps of class 0; class c is c * plane further (one 32-bit
    // multiply-add into each address, not 64-bit pointer arithmetic)
    const T* p_ll = src + row_lo + j;
    const T* p_hl = src + row_hi + j;
    const T* p_lh = src + row_lo + hi;
    const T* p_hh = src + row_hi + hi;
    for (int c0 = 0; c0 < nc; c0 += kCap) {
      float rl[kCap], rh[kCap];
      float bad = 0.0f;  // NaN once one value of the row pass is not finite
#pragma unroll
      for (int c = 0; c < kCap; ++c) {
        if (NC > 0 || c0 + c < nc) {
          const int cp = (c0 + c) * plane;
          rl[c] = lerp_rn(wy0, wy, load_f32(p_ll + cp), load_f32(p_hl + cp));
          rh[c] = lerp_rn(wy0, wy, load_f32(p_lh + cp), load_f32(p_hh + cp));
          bad = __fmaf_rn(rl[c], 0.0f, __fmaf_rn(rh[c], 0.0f, bad));
        }
      }
      if (bad == 0.0f)
        segment<false, T, kCap, NC>(nc, c0, x0, x1, r * W, tx, rl, rh, o,
                                    shift, src, plane, row_lo, row_hi, j, hi,
                                    wy0, wy);
      else
        segment<true, T, kCap, NC>(nc, c0, x0, x1, r * W, tx, rl, rh, o,
                                   shift, src, plane, row_lo, row_hi, j, hi,
                                   wy0, wy);
    }
  }
  if (!stage) return;
  __syncthreads();

  // The band's nr * W labels are contiguous in device memory: a few
  // scalars up to a 16-byte boundary, then 16-byte stores, then the rest.
  const int n = nr * W;
  const int head = min(n, (4 - ((b * H + y0) * W & 3)) & 3);
  const int n_vec = (n - head) >> 2;
  for (int g = threadIdx.x; g < head; g += kThreads) dst[g] = out_s[at(g, 5)];
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const int g = head + 4 * v;
    *reinterpret_cast<int4*>(dst + g) =
        make_int4(out_s[at(g, 5)], out_s[at(g + 1, 5)], out_s[at(g + 2, 5)],
                  out_s[at(g + 3, 5)]);
  }
  for (int g = head + 4 * n_vec + threadIdx.x; g < n; g += kThreads)
    dst[g] = out_s[at(g, 5)];
}

template <typename T, int NC>
int launch_nc(const void* logits, void* out, const void* lo_y,
              const void* hi_y, const void* ty, const void* hi_x,
              const void* tx, const void* xr, int B, int C, int h, int w,
              int H, int W, int rows, int stage, cudaStream_t s) {
  const int n_bands = (H + rows - 1) / rows;
  const int smem = stage ? 4 * stage_words(rows * W) : 0;
  upsample_argmax_band_kernel<T, NC><<<B * n_bands, kThreads, smem, s>>>(
      (const T*)logits, (int32_t*)out, (const int32_t*)lo_y,
      (const int32_t*)hi_y, (const float*)ty, (const int32_t*)hi_x,
      (const float*)tx, (const int32_t*)xr, C, h, w, H, W, rows, n_bands,
      stage);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* logits, void* out, const void* lo_y, const void* hi_y,
           const void* ty, const void* hi_x, const void* tx, const void* xr,
           int B, int C, int h, int w, int H, int W, int rows, int stage,
           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 19)
    return launch_nc<T, 19>(logits, out, lo_y, hi_y, ty, hi_x, tx, xr, B, C,
                            h, w, H, W, rows, stage, s);
  return launch_nc<T, 0>(logits, out, lo_y, hi_y, ty, hi_x, tx, xr, B, C, h,
                         w, H, W, rows, stage, s);
}

}  // namespace

#define UPSAMPLE_ARGMAX(NAME, T)                                              \
  extern "C" int NAME(const void* logits, void* out, const void* lo_y,       \
                      const void* hi_y, const void* ty, const void* hi_x,    \
                      const void* tx, const void* xr, int B, int C, int h,   \
                      int w, int H, int W, int rows, int stage,              \
                      void* stream) {                                        \
    return launch<T>(logits, out, lo_y, hi_y, ty, hi_x, tx, xr, B, C, h, w,  \
                     H, W, rows, stage, stream);                             \
  }

// The geometry the wrapper must share, read by it once at load.
extern "C" int upsample_argmax_threads() { return kThreads; }
extern "C" int upsample_argmax_stage_bytes(int n) { return 4 * stage_words(n); }

UPSAMPLE_ARGMAX(upsample_argmax_f32, float)
UPSAMPLE_ARGMAX(upsample_argmax_bf16, __nv_bfloat16)
