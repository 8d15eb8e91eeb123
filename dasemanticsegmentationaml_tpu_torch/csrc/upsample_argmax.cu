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
//   out  = first c with the largest u[c]   (strict >, as jnp/torch argmax)
// Rows are interpolated first, then columns, as JAX resize.py:109-112 does.
// The taps (lo, hi, t) are the float64-derived fp32 numbers of
// ops/resize.py::_align_corners_taps, passed in as six device arrays.
//
// Numerics: every product and sum is a separate round-to-nearest fp32
// operation (__fmul_rn / __fadd_rn / __fsub_rn, no FMA contraction), so the
// plain PyTorch version (separate multiplies and adds) gives the same bits.
// bf16 logits are widened to fp32 exactly. The TPU kernel's bf16 hi+lo
// "split" tier and its 1-pass "fast" tier existed only because the TPU
// matrix unit is slow in fp32 (upsample_argmax.py:26-40); two-tap fp32
// arithmetic is exact for both input types here, so neither is ported. Nor
// is the TPU tiling (row blocks of 8, VMEM budget, XLA fallbacks): any
// B, C, h, w, H, W >= 1 is taken.
//
// Bound: per 512 x 1024 output image the kernel writes 2 MB of int32 and
// reads 19 x 64 x 128 x 4 B = 0.62 MB of fp32 logits; neighbouring output
// pixels read the same four source pixels, so after the first touch the
// reads hit L1/L2 and the kernel is bound by the output write to device
// memory. Design: one thread per output pixel along x (coalesced int32
// stores), a grid-stride loop over all B*H*W pixels so any size fits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void upsample_argmax_kernel(
    const T* __restrict__ logits, int32_t* __restrict__ out,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ lo_x,
    const int32_t* __restrict__ hi_x, const float* __restrict__ tx,
    int C, int h, int w, int H, int W, int64_t n_pixels) {
  const int64_t plane = (int64_t)h * w;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pixels; p += (int64_t)gridDim.x * blockDim.x) {
    const int x = (int)(p % W);
    const int64_t by = p / W;
    const int y = (int)(by % H);
    const int64_t b = by / H;

    const float wy = __ldg(ty + y);
    const float wy0 = __fsub_rn(1.0f, wy);
    const float wx = __ldg(tx + x);
    const float wx0 = __fsub_rn(1.0f, wx);
    const int64_t row_lo = (int64_t)__ldg(lo_y + y) * w;
    const int64_t row_hi = (int64_t)__ldg(hi_y + y) * w;
    const int col_lo = __ldg(lo_x + x);
    const int col_hi = __ldg(hi_x + x);

    const T* src = logits + b * C * plane;
    float best = 0.0f;
    int arg = 0;
    for (int c = 0; c < C; ++c, src += plane) {
      const float a00 = load_f32(src + row_lo + col_lo);
      const float a10 = load_f32(src + row_hi + col_lo);
      const float a01 = load_f32(src + row_lo + col_hi);
      const float a11 = load_f32(src + row_hi + col_hi);
      const float r_lo = __fadd_rn(__fmul_rn(wy0, a00), __fmul_rn(wy, a10));
      const float r_hi = __fadd_rn(__fmul_rn(wy0, a01), __fmul_rn(wy, a11));
      const float u = __fadd_rn(__fmul_rn(wx0, r_lo), __fmul_rn(wx, r_hi));
      if (c == 0 || u > best) {
        best = u;
        arg = c;
      }
    }
    out[p] = arg;
  }
}

template <typename T>
int launch(const void* logits, void* out, const void* lo_y, const void* hi_y,
           const void* ty, const void* lo_x, const void* hi_x, const void* tx,
           int B, int C, int h, int w, int H, int W, void* stream) {
  const int64_t n_pixels = (int64_t)B * H * W;
  if (n_pixels == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n_pixels + threads - 1) / threads;
  // a grid-stride loop covers the rest; 132 SMs x 16 resident blocks
  if (blocks > 132 * 16) blocks = 132 * 16;
  upsample_argmax_kernel<T><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const T*)logits, (int32_t*)out, (const int32_t*)lo_y,
      (const int32_t*)hi_y, (const float*)ty, (const int32_t*)lo_x,
      (const int32_t*)hi_x, (const float*)tx, C, h, w, H, W, n_pixels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upsample_argmax_f32(const void* logits, void* out,
                                   const void* lo_y, const void* hi_y,
                                   const void* ty, const void* lo_x,
                                   const void* hi_x, const void* tx, int B,
                                   int C, int h, int w, int H, int W,
                                   void* stream) {
  return launch<float>(logits, out, lo_y, hi_y, ty, lo_x, hi_x, tx, B, C, h,
                       w, H, W, stream);
}

extern "C" int upsample_argmax_bf16(const void* logits, void* out,
                                    const void* lo_y, const void* hi_y,
                                    const void* ty, const void* lo_x,
                                    const void* hi_x, const void* tx, int B,
                                    int C, int h, int w, int H, int W,
                                    void* stream) {
  return launch<__nv_bfloat16>(logits, out, lo_y, hi_y, ty, lo_x, hi_x, tx, B,
                               C, h, w, H, W, stream);
}
