// Fused bilinear upsample (align_corners=True) + cross-entropy with an
// ignore label, forward and backward, for Hopper.
//
// Replaces the Pallas TPU kernel
// dasemanticsegmentationaml_tpu/ops/pallas/fused_ce.py
// (cross_entropy_upsampled :303; the custom VJP _fused_ce :240; forward
// _fwd_call :101 / _fwd_kernel :67; backward _bwd_call :189 /
// _bwd_kernel :146). The supervised loss (reference train.py:86-89) is
// CE(ignore=255) on each BiSeNet head after the align_corners upsample to
// the input size (model_stages.py:240-242). Unfused, one head's upsampled
// fp32 logits at batch 8 and 1024 x 512 take 8*19*1024*512*4 B = 319 MB,
// written and read again, and their gradient as much once more. Here the
// full-resolution logits and their gradient never reach device memory.
//
// What it computes. Per output pixel (b, y, x), as csrc/upsample_argmax.cu:
//   r_lo = (1-ty) * X[c, lo_y, lo_x] + ty * X[c, hi_y, lo_x]
//   r_hi = (1-ty) * X[c, lo_y, hi_x] + ty * X[c, hi_y, hi_x]
//   u[c] = (1-tx) * r_lo + tx * r_hi
// then m = max_c u, s = sum_c exp(u - m), loss = m + log(s) - u[label] for
// a valid pixel (label != ignore and 0 <= label < C), 0 otherwise.
// Forward: the mean loss over valid pixels, the count clamped to 1.
// Backward, with g the incoming gradient and N the clamped count:
//   P[c, y, x]  = (softmax_c - onehot_c) * valid * g / N
//   T[c, y, j]  = sum_x Mc[x, j] * P[c, y, x]        (column taps)
//   dX[c, i, j] = sum_y Mr[y, i] * T[c, y, j]        (row taps)
//
// Numerics. The TPU kernel rounds its taps and its row interpolation to
// bf16 for the matrix unit (fused_ce.py:69-73), which is why the JAX
// package keeps fp32 logits off it. Here every product and sum of the
// interpolation is a separate round-to-nearest fp32 operation (__fmul_rn /
// __fadd_rn / __fsub_rn, no FMA contraction), bf16 logits are widened
// exactly, and max, exp, log and the picked logit are fp32: exact
// interpolation for both input types, so fp32 and bf16 both come here.
// The bf16 tap tiers are not ported.
//
// Cross-block sums without atomics. The TPU grid runs in order, so its
// forward writes (loss sum, valid count) per (image, row block) for the
// wrapper to add up, and its backward carries dX across row blocks in a
// resident output block (fused_ce.py:180-186). Hopper blocks run in
// parallel and in no order, so:
//   * forward: one block per output row (b, y) writes its partial loss sum
//     and count; one finishing block adds the B*H partials in a fixed order
//     (double) and writes the loss and N to device memory: no host sync.
//   * backward, gather form: (i) one block per output row (b, y) computes P
//     for a chunk of 256 pixels into shared memory, then each (c, j) sums
//     the contiguous x range whose lo (then hi) column tap is j and adds it
//     to T[b, c, y, j], a row no other block touches; (ii) one thread per
//     dX element sums the contiguous y ranges whose row taps are i.
//   Every sum runs in a fixed order, so the same inputs give the same bits.
//   T is B*C*H*w fp32 (40 MB at 8 x 19 x 1024 x 64): w/W of the
//   full-resolution gradient, which is never written.
//
// Bound on this card, per head at batch 8 and 1024 x 512: the forward reads
// the 16.8 MB of int32 labels once and the low-res logits (1.2 MB fp32)
// mostly from L1/L2, and takes 19 exp per pixel (80 M); both are far below
// a millisecond at 3.35 TB/s, so it should be bound by the 4 x 19 cached
// logit loads and the instruction issue per pixel. The backward does the
// same work plus 19 divides per pixel, writes and rereads T (40 MB each
// way, plus 40 MB of zeroing) and writes dX (1.2 MB). No tensor cores,
// TMA or tiling of the logits in shared memory: that is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 32;       // the wrapper refuses more classes
constexpr int kThreads = 256;   // threads per block, and the x chunk width

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The C upsampled logits of output pixel (b, y, x) into u[0..C).
template <typename T>
__device__ __forceinline__ void upsample_pixel(
    const T* __restrict__ src, int64_t plane, int C, int w, int y, int x,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ lo_x,
    const int32_t* __restrict__ hi_x, const float* __restrict__ tx,
    float (&u)[kMaxC]) {
  const float wy = __ldg(ty + y);
  const float wy0 = __fsub_rn(1.0f, wy);
  const float wx = __ldg(tx + x);
  const float wx0 = __fsub_rn(1.0f, wx);
  const int64_t row_lo = (int64_t)__ldg(lo_y + y) * w;
  const int64_t row_hi = (int64_t)__ldg(hi_y + y) * w;
  const int col_lo = __ldg(lo_x + x);
  const int col_hi = __ldg(hi_x + x);
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const T* s = src + c * plane;
      const float a00 = load_f32(s + row_lo + col_lo);
      const float a10 = load_f32(s + row_hi + col_lo);
      const float a01 = load_f32(s + row_lo + col_hi);
      const float a11 = load_f32(s + row_hi + col_hi);
      const float r_lo = __fadd_rn(__fmul_rn(wy0, a00), __fmul_rn(wy, a10));
      const float r_hi = __fadd_rn(__fmul_rn(wy0, a01), __fmul_rn(wy, a11));
      u[c] = __fadd_rn(__fmul_rn(wx0, r_lo), __fmul_rn(wx, r_hi));
    }
  }
}

// Sum over the block in a fixed order; the result is valid in thread 0.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  V total = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += scratch[i];
  }
  __syncthreads();
  return total;
}

// Forward, one block per output row (b, y): partial loss sum and count.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_rows_kernel(
    const T* __restrict__ logits, const int32_t* __restrict__ labels,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ lo_x,
    const int32_t* __restrict__ hi_x, const float* __restrict__ tx, int C,
    int h, int w, int H, int W, int ignore, float* __restrict__ part_sum,
    int* __restrict__ part_cnt) {
  __shared__ float f_scratch[kThreads / 32];
  __shared__ int i_scratch[kThreads / 32];
  const int64_t row = blockIdx.x;
  const int y = (int)(row % H);
  const int64_t b = row / H;
  const int64_t plane = (int64_t)h * w;
  const T* src = logits + b * C * plane;
  const int32_t* lab_row = labels + row * W;

  float loss_sum = 0.0f;
  int count = 0;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int label = __ldg(lab_row + x);
    if (label == ignore || label < 0 || label >= C) continue;
    float u[kMaxC];
    upsample_pixel(src, plane, C, w, y, x, lo_y, hi_y, ty, lo_x, hi_x, tx, u);
    float m = u[0];
#pragma unroll
    for (int c = 1; c < kMaxC; ++c)
      if (c < C) m = fmaxf(m, u[c]);
    float s = 0.0f, pick = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        s = __fadd_rn(s, expf(__fsub_rn(u[c], m)));
        if (c == label) pick = u[c];
      }
    }
    loss_sum = __fadd_rn(loss_sum, __fsub_rn(__fadd_rn(m, logf(s)), pick));
    ++count;
  }
  loss_sum = block_sum(loss_sum, f_scratch);
  count = block_sum(count, i_scratch);
  if (threadIdx.x == 0) {
    part_sum[row] = loss_sum;
    part_cnt[row] = count;
  }
}

// One block of 1024 threads: the partials in a fixed order -> loss, N.
__global__ void __launch_bounds__(1024) ce_fwd_finish_kernel(
    const float* __restrict__ part_sum, const int* __restrict__ part_cnt,
    int64_t n_parts, float* __restrict__ loss_out, float* __restrict__ n_out) {
  __shared__ double d_scratch[1024];
  __shared__ long long c_scratch[1024];
  double s = 0.0;
  long long c = 0;
  for (int64_t i = threadIdx.x; i < n_parts; i += blockDim.x) {
    s += (double)part_sum[i];
    c += part_cnt[i];
  }
  d_scratch[threadIdx.x] = s;
  c_scratch[threadIdx.x] = c;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) {
      d_scratch[threadIdx.x] += d_scratch[threadIdx.x + half];
      c_scratch[threadIdx.x] += c_scratch[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float n = (float)(c_scratch[0] > 1 ? c_scratch[0] : 1);
    loss_out[0] = __fdiv_rn((float)d_scratch[0], n);
    n_out[0] = n;
  }
}

// Backward (i), one block per output row (b, y):
// T[b, c, y, j] = sum_x Mc[x, j] * P[b, c, y, x].
// xr[4j .. 4j+3]: [start, end) of the x whose lo column tap is j, then of
// the x whose hi column tap is j (contiguous: the taps are monotone).
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_rows_kernel(
    const T* __restrict__ logits, const int32_t* __restrict__ labels,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ lo_x,
    const int32_t* __restrict__ hi_x, const float* __restrict__ tx,
    const int32_t* __restrict__ xr, const float* __restrict__ g,
    const float* __restrict__ n, int C, int h, int w, int H, int W,
    int ignore, float* __restrict__ tbuf) {
  __shared__ float p_s[kMaxC * kThreads];
  const int64_t row = blockIdx.x;
  const int y = (int)(row % H);
  const int64_t b = row / H;
  const int64_t plane = (int64_t)h * w;
  const T* src = logits + b * C * plane;
  const int32_t* lab_row = labels + row * W;
  const float gscale = __fdiv_rn(__ldg(g), __ldg(n));
  // T[b, c, y, :] starts at t_row + c * H * w
  float* t_row = tbuf + (b * C * H + y) * (int64_t)w;
  const int64_t c_stride = (int64_t)H * w;

  for (int i = threadIdx.x; i < C * w; i += blockDim.x)
    t_row[(i / w) * c_stride + i % w] = 0.0f;

  for (int x0 = 0; x0 < W; x0 += kThreads) {
    const int x = x0 + threadIdx.x;
    if (x < W) {
      const int label = __ldg(lab_row + x);
      const bool valid = label != ignore && label >= 0 && label < C;
      if (valid) {
        float u[kMaxC];
        upsample_pixel(src, plane, C, w, y, x, lo_y, hi_y, ty, lo_x, hi_x, tx,
                       u);
        float m = u[0];
#pragma unroll
        for (int c = 1; c < kMaxC; ++c)
          if (c < C) m = fmaxf(m, u[c]);
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          if (c < C) {
            u[c] = expf(__fsub_rn(u[c], m));
            s = __fadd_rn(s, u[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          if (c < C) {
            const float p = __fsub_rn(__fdiv_rn(u[c], s), c == label ? 1.0f : 0.0f);
            p_s[c * kThreads + threadIdx.x] = __fmul_rn(p, gscale);
          }
        }
      } else {
        for (int c = 0; c < C; ++c) p_s[c * kThreads + threadIdx.x] = 0.0f;
      }
    }
    __syncthreads();  // P of the chunk, and T of the last chunk, are visible

    const int x_end = min(x0 + kThreads, W);
    const int j_lo = __ldg(lo_x + x0);
    const int nj = __ldg(hi_x + x_end - 1) - j_lo + 1;
    for (int k = threadIdx.x; k < C * nj; k += blockDim.x) {
      const int c = k / nj;
      const int j = j_lo + k % nj;
      const float* p = p_s + c * kThreads;  // p[xx - x0] is P at x = xx
      float acc = 0.0f;
      for (int xx = max(__ldg(xr + 4 * j), x0), e = min(__ldg(xr + 4 * j + 1), x_end);
           xx < e; ++xx)
        acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(1.0f, __ldg(tx + xx)), p[xx - x0]));
      for (int xx = max(__ldg(xr + 4 * j + 2), x0), e = min(__ldg(xr + 4 * j + 3), x_end);
           xx < e; ++xx)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(tx + xx), p[xx - x0]));
      float* t = t_row + c * c_stride + j;
      *t = __fadd_rn(*t, acc);
    }
    __syncthreads();  // p_s is rewritten by the next chunk
  }
}

// Backward (ii), one thread per dX element (b, c, i, j):
// dX[b, c, i, j] = sum_y Mr[y, i] * T[b, c, y, j], yr as xr for the rows.
template <typename T>
__global__ void ce_bwd_cols_kernel(const float* __restrict__ tbuf,
                                   const int32_t* __restrict__ yr,
                                   const float* __restrict__ ty, int h, int w,
                                   int H, int64_t n_out, T* __restrict__ dx) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n_out; idx += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % w);
    const int64_t t = idx / w;
    const int i = (int)(t % h);
    const int64_t bc = t / h;
    const float* col = tbuf + bc * H * (int64_t)w + j;
    float acc = 0.0f;
    for (int y = __ldg(yr + 4 * i), e = __ldg(yr + 4 * i + 1); y < e; ++y)
      acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(1.0f, __ldg(ty + y)),
                                     col[(int64_t)y * w]));
    for (int y = __ldg(yr + 4 * i + 2), e = __ldg(yr + 4 * i + 3); y < e; ++y)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(ty + y), col[(int64_t)y * w]));
    store_as(dx + idx, acc);
  }
}

template <typename T>
int launch_fwd(const void* logits, const void* labels, const void* lo_y,
               const void* hi_y, const void* ty, const void* lo_x,
               const void* hi_x, const void* tx, int B, int C, int h, int w,
               int H, int W, int ignore, void* part_sum, void* part_cnt,
               void* loss_out, void* n_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = (int64_t)B * H;
  ce_fwd_rows_kernel<T><<<(unsigned)rows, kThreads, 0, s>>>(
      (const T*)logits, (const int32_t*)labels, (const int32_t*)lo_y,
      (const int32_t*)hi_y, (const float*)ty, (const int32_t*)lo_x,
      (const int32_t*)hi_x, (const float*)tx, C, h, w, H, W, ignore,
      (float*)part_sum, (int*)part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_finish_kernel<<<1, 1024, 0, s>>>((const float*)part_sum,
                                          (const int*)part_cnt, rows,
                                          (float*)loss_out, (float*)n_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* logits, const void* labels, const void* lo_y,
               const void* hi_y, const void* ty, const void* lo_x,
               const void* hi_x, const void* tx, const void* xr,
               const void* yr, const void* g, const void* n, int B, int C,
               int h, int w, int H, int W, int ignore, void* tbuf, void* dx,
               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = (int64_t)B * H;
  ce_bwd_rows_kernel<T><<<(unsigned)rows, kThreads, 0, s>>>(
      (const T*)logits, (const int32_t*)labels, (const int32_t*)lo_y,
      (const int32_t*)hi_y, (const float*)ty, (const int32_t*)lo_x,
      (const int32_t*)hi_x, (const float*)tx, (const int32_t*)xr,
      (const float*)g, (const float*)n, C, h, w, H, W, ignore, (float*)tbuf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_out = (int64_t)B * C * h * w;
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // a grid-stride loop does the rest
  ce_bwd_cols_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)tbuf, (const int32_t*)yr, (const float*)ty, h, w, H, n_out,
      (T*)dx);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_CE_FWD(NAME, T)                                                  \
  extern "C" int NAME(const void* logits, const void* labels,                 \
                      const void* lo_y, const void* hi_y, const void* ty,     \
                      const void* lo_x, const void* hi_x, const void* tx,     \
                      int B, int C, int h, int w, int H, int W, int ignore,   \
                      void* part_sum, void* part_cnt, void* loss_out,         \
                      void* n_out, void* stream) {                            \
    return launch_fwd<T>(logits, labels, lo_y, hi_y, ty, lo_x, hi_x, tx, B,   \
                         C, h, w, H, W, ignore, part_sum, part_cnt, loss_out, \
                         n_out, stream);                                      \
  }

#define FUSED_CE_BWD(NAME, T)                                                  \
  extern "C" int NAME(const void* logits, const void* labels,                 \
                      const void* lo_y, const void* hi_y, const void* ty,     \
                      const void* lo_x, const void* hi_x, const void* tx,     \
                      const void* xr, const void* yr, const void* g,          \
                      const void* n, int B, int C, int h, int w, int H,       \
                      int W, int ignore, void* tbuf, void* dx,                \
                      void* stream) {                                         \
    return launch_bwd<T>(logits, labels, lo_y, hi_y, ty, lo_x, hi_x, tx, xr,  \
                         yr, g, n, B, C, h, w, H, W, ignore, tbuf, dx,        \
                         stream);                                             \
  }

FUSED_CE_FWD(fused_ce_fwd_f32, float)
FUSED_CE_FWD(fused_ce_fwd_bf16, __nv_bfloat16)
FUSED_CE_BWD(fused_ce_bwd_f32, float)
FUSED_CE_BWD(fused_ce_bwd_bf16, __nv_bfloat16)
