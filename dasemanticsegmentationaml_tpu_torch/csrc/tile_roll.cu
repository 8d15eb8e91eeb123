// roll(x, shift, dim=1) of a contiguous (R, C) tensor, for Hopper.
//
// Replaces the Pallas TPU kernel tools/mosaic_roll_repro.py::roll_once
// (:30; pallas_call :32, body _kernel :26): pltpu.roll(x, 1, 1) on an
// (8, 128) tile, which Mosaic cannot lower for 16-bit data ("Rotate with
// non-32-bit data", mosaic_roll_repro.py:1-14). The 16-bit case is the
// point of this port. It computes, as torch.roll and jnp.roll do,
//   out[r, j] = x[r, (j - shift) mod C]
// for float32, int32, bfloat16 and int16 (the kernel moves 32-bit words and
// never looks at the values), any integer shift.
//
// Design: a warp-shuffle rotate. A warp takes 32 consecutive output vectors
// of one row; each lane holds one 16-byte vector of 4 32-bit words (4
// values of a 32-bit type, 8 of a 16-bit one). The wrapper takes only rows
// whose bytes are a multiple of 16 and tensors on a 16-byte boundary. With
// U values to a vector, the shift mod C is a whole vectors and R < U values.
// The whole vectors are in the load address: lane k loads input vector
// (k - a) mod V of the row ("hi"), a load as coalesced across the warp as an
// aligned one. The R values that spill over come from input vector
// (k - a - 1) mod V ("lo"), which is the left neighbour's "hi":
// __shfl_up_sync moves it across lanes (the warp's first lane loads its
// own). The output vector is the pair (lo, hi) shifted right by R values:
// whole words are picked, and an odd 16-bit shift takes each word from two
// neighbouring words with __funnelshift_r.
// R is a template parameter, so every word index is a compile-time constant
// and nothing goes through local memory.
//
// Bound: it reads and writes R * C * elem bytes and does no arithmetic, so
// it is bound by bytes: 2 * 256 MB / 3.35 TB/s = 0.160 ms at (16384, 8192)
// bf16. At the repro's (8, 128) it moves 4-8 KB and is bound by the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVW = 4;  // 32-bit words to a 16-byte vector

__device__ __forceinline__ void load_vec(const uint32_t* p, uint32_t (&w)[kVW]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// Output word w of the pair (lo, hi) shifted right by R values, UPW values
// to a word. Little-endian: value 2i of a 16-bit row is the low half of
// word i.
template <int UPW, int R>
__device__ __forceinline__ void combine(const uint32_t (&lo)[kVW],
                                        const uint32_t (&hi)[kVW],
                                        uint32_t (&out)[kVW]) {
  uint32_t c[2 * kVW];
#pragma unroll
  for (int i = 0; i < kVW; ++i) {
    c[i] = lo[i];
    c[kVW + i] = hi[i];
  }
#pragma unroll
  for (int w = 0; w < kVW; ++w) {
    if constexpr (UPW == 1) {
      out[w] = c[kVW + w - R];
    } else if constexpr (R % 2 == 0) {
      out[w] = c[kVW + w - R / 2];
    } else {
      // the high half of word m, then the low half of word m + 1
      constexpr int kBack = (R + 1) / 2;
      out[w] = __funnelshift_r(c[kVW + w - kBack], c[kVW + w - kBack + 1], 16);
    }
  }
}

// x, out: rows of V 16-byte vectors. Warp item t covers vectors
// 32 * (t % per_row) ... of row t / per_row.
template <int UPW, int R>
__global__ void __launch_bounds__(kThreads)
tile_roll_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int64_t rows, int64_t row_vecs, int64_t a) {
  const int lane = threadIdx.x & 31;
  const int64_t per_row = (row_vecs + 31) / 32;
  const int64_t items = rows * per_row;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < items; t += stride) {
    const int64_t row = t / per_row;                 // uniform in the warp
    const int64_t k = (t - row * per_row) * 32 + lane;
    const bool live = k < row_vecs;
    const uint32_t* src = x + row * row_vecs * kVW;
    int64_t hi_k = k - a;
    if (hi_k < 0) hi_k += row_vecs;
    uint32_t hi[kVW] = {0, 0, 0, 0}, lo[kVW] = {0, 0, 0, 0}, res[kVW];
    if (live) load_vec(src + hi_k * kVW, hi);
    if constexpr (R != 0) {
#pragma unroll
      for (int i = 0; i < kVW; ++i) lo[i] = __shfl_up_sync(kFull, hi[i], 1);
      if (live && lane == 0) {
        load_vec(src + (hi_k == 0 ? row_vecs - 1 : hi_k - 1) * kVW, lo);
      }
    }
    if (live) {
      combine<UPW, R>(lo, hi, res);
      *reinterpret_cast<uint4*>(out + (row * row_vecs + k) * kVW) =
          make_uint4(res[0], res[1], res[2], res[3]);
    }
  }
}

template <int UPW, int R = 0>
int launch(int r, const void* x, void* out, int64_t rows, int64_t row_vecs,
           int64_t a, int sms, void* stream) {
  if constexpr (R < UPW * kVW) {
    if (r != R)
      return launch<UPW, R + 1>(r, x, out, rows, row_vecs, a, sms, stream);
    const int64_t items = rows * ((row_vecs + 31) / 32);
    int64_t blocks = (items + kWarps - 1) / kWarps;
    if (blocks > (int64_t)sms * 16) blocks = (int64_t)sms * 16;
    tile_roll_kernel<UPW, R><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, rows, row_vecs, a);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// elem_bytes: 2 or 4. cols * elem_bytes must be a multiple of 16 and both
// pointers 16-byte aligned; anything else returns cudaErrorInvalidValue.
extern "C" int tile_roll(const void* x, void* out, long long rows,
                         long long cols, int elem_bytes, long long shift,
                         int sms, void* stream) {
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  if ((cols * elem_bytes) % 16 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int upw = 4 / elem_bytes;
  const long long per_vec = (long long)upw * kVW;   // values to a vector
  const long long row_vecs = cols / per_vec;
  long long s = shift % cols;
  if (s < 0) s += cols;
  const long long a = s / per_vec;
  const int r = (int)(s % per_vec);
  return upw == 2 ? launch<2>(r, x, out, rows, row_vecs, a, sms, stream)
                  : launch<1>(r, x, out, rows, row_vecs, a, sms, stream);
}
