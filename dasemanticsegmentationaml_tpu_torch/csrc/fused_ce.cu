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
// The bf16 tap tiers are not ported. exp and the forward's log are the
// SFU's (ex2 / lg2.approx, see exp_sum). The backward's softmax scale is
// the TPU kernel's (_bwd_kernel :169-173): one divide a pixel, (g/N)/s,
// then P = e * scale - onehot * g/N by one FMA a class (it was 19 divides
// a pixel); its adjoint sums use FMAs, in a fixed order.
//
// Tensor cores are not the tool. Both adjoints are 2-tap sparse products:
// a dense wgmma form (the TPU kernel's matrix-unit form, fused_ce.py:69-73,
// 149-175) does ~W/2 times the work and rounds P to bf16 or TF32, which
// breaks the gradient bound of 1e-4 * max|grad| against the plain version.
//
// Design. One thread owns one column segment of one output row: the x
// whose lo column tap is j (contiguous, since the taps are monotone; about
// W/w = 8 pixels at the train step's heads), all of which share the column
// taps j and hi = min(j+1, w-1). So a thread does the row pass (the
// vertical interpolation) once per class for its two columns, keeps those
// 2*C values in registers, and each of its pixels does only the horizontal
// pass: no per-pixel gathers, a third of the interpolation arithmetic.
// The row pass reads the logits through L1 (a warp reads consecutive
// columns); every output row of a block reuses the same two source rows,
// so the logits are not staged in shared memory: the row pass is 2*C*w
// loads per output row against 4*C*W gathers before.
//
//   * forward: one block per band of output rows of one image (rows per
//     band from the work, ops/cuda/fused_ce.py::fwd_rows_per_band), each
//     thread a (row, segment) at a time; the block's partial loss sum and
//     count go to device memory and one finishing block adds the partials
//     in a fixed order (double) into the loss and N: no host sync.
//   * backward, one pass in which T never reaches device memory: one block
//     per band of k source rows [i0, i0+k) of one image (k from the work
//     and the shared-memory budget, ops/cuda/fused_ce.py::bwd_geometry). It
//     walks, in passes of a few rows, the output rows whose lo row tap lies
//     in the band (band_y, ops/cuda/fused_ce.py::band_rows). Per pixel it
//     forms P and adds (1-tx)*P and tx*P into the segment's two column
//     sums in registers: the column adjoint needs no cross-thread
//     reduction beyond adding a column's sum to its left neighbour's hi
//     sum, through shared memory. Then one thread per (c, j) adds
//     (1-ty)*T and ty*T, row by row in y order, into the band's dX rows,
//     held in shared memory (fp32, C*(k+1)*w). dX is written once, in the
//     logits' dtype.
//     Edges without atomics: an output row whose lo tap is the band's last
//     row puts its hi part into row i0+k, the next band's first. The band
//     writes that row's partial to edge_e (fp32, C*w a band) and its own
//     first row's partial to edge_f; a small second kernel writes those
//     rows as edge_e of the band above + edge_f, in that order (the y
//     order). That is (B*(h/k))*C*w elements, 1/k of dX, and no scratch of
//     the full-resolution size. Recomputing the boundary rows in both bands
//     instead would cost 1/k more of the heavy pixel work.
//   Every sum runs in a fixed order and no float atomics are used, so the
//   same inputs give the same bits.
//
// Bound on this card, per head at batch 8 and 1024 x 512: 80 M exp (68 M
// on valid pixels) at the SFU's 16 a clock an SM, on all of an H100's SMs,
// is ~0.02 ms; the 16.8 MB of int32 labels take 0.005 ms. Measured on an
// H100 (PERF.md §6), the forward takes ~0.057 ms and the backward ~0.12
// ms: neither the SFU nor memory nor shared memory limits them,
// instruction issue does. Per valid pixel and class the forward issues
// about eight instructions (horizontal pass 3, max, exp 2, sum), the
// backward about fifteen (P and its two column sums, the one-hot select),
// with lanes idle on ignored pixels and on the shorter segments of a warp;
// the forward holds 3 blocks an SM (80 registers), the backward 2 (128).
// Grid sizes come from the work (no SM count is hard-coded here: the
// wrapper passes what it derives from the card).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 32;       // the wrapper refuses more classes
constexpr int kThreads = 256;   // threads per block (ops/cuda/fused_ce.py::THREADS)

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// One column segment of output row y: the x in [x0, x1) whose lo column
// tap is j; their hi tap is hi. rl / rh: the row pass at columns j and hi,
// for every class.
template <typename T, int NC>
struct Segment {
  static constexpr int kCap = NC > 0 ? NC : kMaxC;
  int x0, x1, hi;
  float rl[kCap], rh[kCap];

  __device__ __forceinline__ Segment(const T* __restrict__ src, int C,
                                     int64_t plane, int w, int y, int j,
                                     const int32_t* __restrict__ lo_y,
                                     const int32_t* __restrict__ hi_y,
                                     const float* __restrict__ ty,
                                     const int32_t* __restrict__ hi_x,
                                     const int32_t* __restrict__ xr) {
    x0 = __ldg(xr + 4 * j);
    x1 = __ldg(xr + 4 * j + 1);
    hi = x0 < x1 ? __ldg(hi_x + x0) : j;
    if (x0 == x1) return;
    const float wy = __ldg(ty + y);
    const float wy0 = __fsub_rn(1.0f, wy);
    const int64_t row_lo = (int64_t)__ldg(lo_y + y) * w;
    const int64_t row_hi = (int64_t)__ldg(hi_y + y) * w;
#pragma unroll
    for (int c = 0; c < kCap; ++c) {
      if (NC > 0 || c < C) {
        const T* s = src + c * plane;
        rl[c] = __fadd_rn(__fmul_rn(wy0, load_f32(s + row_lo + j)),
                          __fmul_rn(wy, load_f32(s + row_hi + j)));
        rh[c] = __fadd_rn(__fmul_rn(wy0, load_f32(s + row_lo + hi)),
                          __fmul_rn(wy, load_f32(s + row_hi + hi)));
      }
    }
  }

  // The C upsampled logits of pixel x of the segment, and their max (four
  // running maxima, then their max: a short dependency chain).
  __device__ __forceinline__ float pixel(int C, float wx, float (&u)[kCap]) const {
    const float wx0 = __fsub_rn(1.0f, wx);
    const float inf = __int_as_float(0x7f800000);
    float m[4] = {-inf, -inf, -inf, -inf};
#pragma unroll
    for (int c = 0; c < kCap; ++c) {
      if (NC > 0 || c < C) {
        u[c] = __fadd_rn(__fmul_rn(wx0, rl[c]), __fmul_rn(wx, rh[c]));
        m[c & 3] = fmaxf(m[c & 3], u[c]);
      }
    }
    return fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
  }
};

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// u[c] <- exp(u[c] - m) for every class; returns their sum (four running
// sums, then theirs, in a fixed order). exp(u - m) is 2^(u*log2(e) -
// m*log2(e)): one FMA and the SFU's ex2, against expf's ~7 instructions.
// Its relative error is about 2^-21 for the arguments here (<= 0, a few
// tens at most, where the term still counts): far inside the bounds
// against the plain version (loss 1e-5 relative, gradient 1e-4 of its
// max).
template <int kCap, int NC>
__device__ __forceinline__ float exp_sum(int C, float m, float (&u)[kCap]) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float ml = -m * kLog2e;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (NC > 0 || c < C) {
      u[c] = exp2_sfu(__fmaf_rn(u[c], kLog2e, ml));
      s[c & 3] = __fadd_rn(s[c & 3], u[c]);
    }
  }
  return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
}

__device__ __forceinline__ bool valid_label(int label, int C, int ignore) {
  return label != ignore && label >= 0 && label < C;
}

// Forward, one block per band of `rows` output rows of one image: the
// band's partial loss sum and count.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC > 0 ? 3 : 1) ce_fwd_band_kernel(
    const T* __restrict__ logits, const int32_t* __restrict__ labels,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ hi_x,
    const float* __restrict__ tx, const int32_t* __restrict__ xr, int C,
    int h, int w, int H, int W, int ignore, int rows, int n_bands,
    float* __restrict__ part_sum, int* __restrict__ part_cnt) {
  using Seg = Segment<T, NC>;
  __shared__ float f_scratch[kThreads / 32];
  __shared__ int i_scratch[kThreads / 32];
  // each thread's row pass again, [class][thread]: the picked logit is one
  // pixel's horizontal pass at its label, read by a dynamic index
  extern __shared__ float rows_s[];
  float* rl_s = rows_s + threadIdx.x;
  float* rh_s = rl_s + C * kThreads;
  const int band = (int)(blockIdx.x % n_bands);
  const int64_t b = blockIdx.x / n_bands;
  const int y0 = band * rows;
  const int items = min(rows, H - y0) * w;
  const int64_t plane = (int64_t)h * w;
  const T* src = logits + b * C * plane;

  float loss_sum = 0.0f;
  int count = 0;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int y = y0 + item / w, j = item % w;
    const Seg seg(src, C, plane, w, y, j, lo_y, hi_y, ty, hi_x, xr);
    if (seg.x0 == seg.x1) continue;
#pragma unroll
    for (int c = 0; c < Seg::kCap; ++c) {
      if (NC > 0 || c < C) {
        rl_s[c * kThreads] = seg.rl[c];
        rh_s[c * kThreads] = seg.rh[c];
      }
    }
    const int32_t* lab_row = labels + (b * H + y) * (int64_t)W;
    int label = __ldg(lab_row + seg.x0);
    for (int x = seg.x0; x < seg.x1; ++x) {
      const int next = x + 1 < seg.x1 ? __ldg(lab_row + x + 1) : 0;  // ahead
      if (valid_label(label, C, ignore)) {
        const float wx = __ldg(tx + x);
        float u[Seg::kCap];
        const float m = seg.pixel(C, wx, u);
        const float pick = __fadd_rn(
            __fmul_rn(__fsub_rn(1.0f, wx), rl_s[label * kThreads]),
            __fmul_rn(wx, rh_s[label * kThreads]));  // = u[label], bit for bit
        const float s = exp_sum<Seg::kCap, NC>(C, m, u);
        // log by the SFU too (lg2.approx; absolute error about 2^-22)
        loss_sum = __fadd_rn(loss_sum, __fsub_rn(__fadd_rn(m, __logf(s)), pick));
        ++count;
      }
      label = next;
    }
  }
  loss_sum = block_sum(loss_sum, f_scratch);
  count = block_sum(count, i_scratch);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = loss_sum;
    part_cnt[blockIdx.x] = count;
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

// Backward, one block per band of k source rows [i0, i0 + k) of one image:
// dX of the band, the output rows y in [band_y[band], band_y[band + 1])
// walked `rpp` rows a pass. Shared memory (fp32): acc[C][k+1][w] (the
// band's rows and the next band's first), tl[rpp][C][w] (each segment's
// lo-tap sum) and th[rpp][C][w+1] (its hi-tap sum, one column right).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC > 0 ? 2 : 1) ce_bwd_band_kernel(
    const T* __restrict__ logits, const int32_t* __restrict__ labels,
    const int32_t* __restrict__ lo_y, const int32_t* __restrict__ hi_y,
    const float* __restrict__ ty, const int32_t* __restrict__ hi_x,
    const float* __restrict__ tx, const int32_t* __restrict__ xr,
    const int32_t* __restrict__ band_y, const float* __restrict__ g,
    const float* __restrict__ n, int C, int h, int w, int H, int W,
    int ignore, int k, int rpp, int n_bands, float* __restrict__ edge_e,
    float* __restrict__ edge_f, T* __restrict__ dx) {
  using Seg = Segment<T, NC>;
  constexpr int kCap = Seg::kCap;
  extern __shared__ float smem[];
  float* acc = smem;
  float* tl = acc + C * (k + 1) * w;
  float* th = tl + rpp * C * w;
  const int band = (int)(blockIdx.x % n_bands);
  const int64_t b = blockIdx.x / n_bands;
  const int i0 = band * k, kn = min(k, h - i0);
  const int y_end = __ldg(band_y + band + 1);
  const int64_t plane = (int64_t)h * w;
  const T* src = logits + b * C * plane;
  const float gscale = __fdiv_rn(__ldg(g), __ldg(n));

  for (int e = threadIdx.x; e < C * (k + 1) * w; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();

  for (int yp = __ldg(band_y + band); yp < y_end; yp += rpp) {
    const int nr = min(rpp, y_end - yp);
    for (int item = threadIdx.x; item < nr * w; item += blockDim.x) {
      const int r = item / w, j = item % w, y = yp + r;
      const Seg seg(src, C, plane, w, y, j, lo_y, hi_y, ty, hi_x, xr);
      float tlo[kCap], thi[kCap];
#pragma unroll
      for (int c = 0; c < kCap; ++c) tlo[c] = thi[c] = 0.0f;
      const int32_t* lab_row = labels + (b * H + y) * (int64_t)W;
      int label = seg.x0 < seg.x1 ? __ldg(lab_row + seg.x0) : 0;
      for (int x = seg.x0; x < seg.x1; ++x) {
        const int next = x + 1 < seg.x1 ? __ldg(lab_row + x + 1) : 0;
        if (valid_label(label, C, ignore)) {
          const float wx = __ldg(tx + x);
          float u[kCap];
          const float m = seg.pixel(C, wx, u);
          const float scale = __fdiv_rn(gscale, exp_sum<kCap, NC>(C, m, u));
          const float wx0 = __fsub_rn(1.0f, wx);
#pragma unroll
          for (int c = 0; c < kCap; ++c) {
            if (NC > 0 || c < C) {
              const float p = __fmaf_rn(u[c], scale, c == label ? -gscale : 0.0f);
              tlo[c] = __fmaf_rn(wx0, p, tlo[c]);
              thi[c] = __fmaf_rn(wx, p, thi[c]);
            }
          }
        }
        label = next;
      }
      float* tlr = tl + r * C * w;
      float* thr = th + r * C * (w + 1);
#pragma unroll
      for (int c = 0; c < kCap; ++c) {
        if (NC > 0 || c < C) {
          if (seg.hi == j) {  // last column, or one source column
            tlr[c * w + j] = __fadd_rn(tlo[c], thi[c]);
            thr[c * (w + 1) + j + 1] = 0.0f;
          } else {
            tlr[c * w + j] = tlo[c];
            thr[c * (w + 1) + j + 1] = thi[c];
          }
          if (j == 0) thr[c * (w + 1)] = 0.0f;
        }
      }
    }
    __syncthreads();  // every segment's sums of this pass are in tl / th

    for (int e = threadIdx.x; e < C * w; e += blockDim.x) {
      const int c = e / w, j = e % w;
      for (int r = 0; r < nr; ++r) {
        const int y = yp + r;
        const float t = __fadd_rn(tl[(r * C + c) * w + j],
                                  th[(r * C + c) * (w + 1) + j]);
        const float wy = __ldg(ty + y);
        float* a_lo = acc + (c * (k + 1) + __ldg(lo_y + y) - i0) * w + j;
        *a_lo = __fmaf_rn(__fsub_rn(1.0f, wy), t, *a_lo);
        float* a_hi = acc + (c * (k + 1) + __ldg(hi_y + y) - i0) * w + j;
        *a_hi = __fmaf_rn(wy, t, *a_hi);
      }
    }
    __syncthreads();  // tl / th are rewritten by the next pass
  }

  const int64_t edge = ((b * n_bands + band) * C) * (int64_t)w;
  for (int e = threadIdx.x; e < C * kn * w; e += blockDim.x) {
    const int c = e / (kn * w), r = (e / w) % kn, j = e % w;
    const float v = acc[(c * (k + 1) + r) * w + j];
    if (r == 0 && band > 0)
      edge_f[edge + c * w + j] = v;
    else
      store_as(dx + ((b * C + c) * h + i0 + r) * (int64_t)w + j, v);
  }
  if (band + 1 < n_bands) {
    for (int e = threadIdx.x; e < C * w; e += blockDim.x)
      edge_e[edge + e] = acc[((e / w) * (k + 1) + k) * w + e % w];
  }
}

// The first row of every band but the first: the band above's partial
// (its last output rows' hi taps), then the band's own, in that order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_edge_kernel(
    const float* __restrict__ edge_e, const float* __restrict__ edge_f, int C,
    int h, int w, int k, int n_bands, int64_t n_out, T* __restrict__ dx) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int j = (int)(idx % w);
  int64_t t = idx / w;
  const int c = (int)(t % C);
  t /= C;
  const int band = (int)(t % (n_bands - 1)) + 1;
  const int64_t b = t / (n_bands - 1);
  const float e = edge_e[((b * n_bands + band - 1) * C + c) * (int64_t)w + j];
  const float f = edge_f[((b * n_bands + band) * C + c) * (int64_t)w + j];
  store_as(dx + ((b * C + c) * h + (int64_t)band * k) * w + j, __fadd_rn(e, f));
}

// The layout of ce_bwd_band_kernel's shared memory; the wrapper's
// ops/cuda/fused_ce.py::bwd_smem_bytes sizes the geometry by it, and
// checks once, at load, that the two agree (fused_ce_bwd_smem_bytes).
int bwd_smem_bytes(int C, int w, int k, int rpp) {
  return 4 * C * ((k + 1) * w + rpp * w + rpp * (w + 1));
}

template <typename T, int NC>
int launch_fwd_nc(const void* logits, const void* labels, const void* lo_y,
                  const void* hi_y, const void* ty, const void* hi_x,
                  const void* tx, const void* xr, int B, int C, int h, int w,
                  int H, int W, int ignore, int rows, void* part_sum,
                  void* part_cnt, void* loss_out, void* n_out,
                  cudaStream_t s) {
  const int n_bands = (H + rows - 1) / rows;
  const int64_t blocks = (int64_t)B * n_bands;
  const int smem = 2 * C * kThreads * (int)sizeof(float);
  if (smem > 48 * 1024) {  // on every launch: the attribute is per device
    cudaError_t err = cudaFuncSetAttribute(
        ce_fwd_band_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  ce_fwd_band_kernel<T, NC><<<(unsigned)blocks, kThreads, smem, s>>>(
      (const T*)logits, (const int32_t*)labels, (const int32_t*)lo_y,
      (const int32_t*)hi_y, (const float*)ty, (const int32_t*)hi_x,
      (const float*)tx, (const int32_t*)xr, C, h, w, H, W, ignore, rows,
      n_bands, (float*)part_sum, (int*)part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_finish_kernel<<<1, 1024, 0, s>>>((const float*)part_sum,
                                          (const int*)part_cnt, blocks,
                                          (float*)loss_out, (float*)n_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* logits, const void* labels, const void* lo_y,
               const void* hi_y, const void* ty, const void* hi_x,
               const void* tx, const void* xr, int B, int C, int h, int w,
               int H, int W, int ignore, int rows, void* part_sum,
               void* part_cnt, void* loss_out, void* n_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 19)
    return launch_fwd_nc<T, 19>(logits, labels, lo_y, hi_y, ty, hi_x, tx, xr,
                                B, C, h, w, H, W, ignore, rows, part_sum,
                                part_cnt, loss_out, n_out, s);
  return launch_fwd_nc<T, 0>(logits, labels, lo_y, hi_y, ty, hi_x, tx, xr, B,
                             C, h, w, H, W, ignore, rows, part_sum, part_cnt,
                             loss_out, n_out, s);
}

template <typename T, int NC>
int launch_bwd_nc(const void* logits, const void* labels, const void* lo_y,
                  const void* hi_y, const void* ty, const void* hi_x,
                  const void* tx, const void* xr, const void* band_y,
                  const void* g, const void* n, int B, int C, int h, int w,
                  int H, int W, int ignore, int k, int rpp, void* edge_e,
                  void* edge_f, void* dx, cudaStream_t s) {
  const int smem = bwd_smem_bytes(C, w, k, rpp);
  // on every launch: the attribute is per device; past the card's limit
  // this returns the card's error, the only check of the size here
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ce_bwd_band_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_bands = (h + k - 1) / k;
  ce_bwd_band_kernel<T, NC><<<(unsigned)((int64_t)B * n_bands), kThreads, smem, s>>>(
      (const T*)logits, (const int32_t*)labels, (const int32_t*)lo_y,
      (const int32_t*)hi_y, (const float*)ty, (const int32_t*)hi_x,
      (const float*)tx, (const int32_t*)xr, (const int32_t*)band_y,
      (const float*)g, (const float*)n, C, h, w, H, W, ignore, k, rpp,
      n_bands, (float*)edge_e, (float*)edge_f, (T*)dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_bands == 1) return (int)err;
  const int64_t n_out = (int64_t)B * (n_bands - 1) * C * w;
  ce_bwd_edge_kernel<T><<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)edge_e, (const float*)edge_f, C, h, w, k, n_bands, n_out,
      (T*)dx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* logits, const void* labels, const void* lo_y,
               const void* hi_y, const void* ty, const void* hi_x,
               const void* tx, const void* xr, const void* band_y,
               const void* g, const void* n, int B, int C, int h, int w,
               int H, int W, int ignore, int k, int rpp, void* edge_e,
               void* edge_f, void* dx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 19)
    return launch_bwd_nc<T, 19>(logits, labels, lo_y, hi_y, ty, hi_x, tx, xr,
                                band_y, g, n, B, C, h, w, H, W, ignore, k,
                                rpp, edge_e, edge_f, dx, s);
  return launch_bwd_nc<T, 0>(logits, labels, lo_y, hi_y, ty, hi_x, tx, xr,
                             band_y, g, n, B, C, h, w, H, W, ignore, k, rpp,
                             edge_e, edge_f, dx, s);
}

}  // namespace

#define FUSED_CE_FWD(NAME, T)                                                  \
  extern "C" int NAME(const void* logits, const void* labels,                 \
                      const void* lo_y, const void* hi_y, const void* ty,     \
                      const void* hi_x, const void* tx, const void* xr,       \
                      int B, int C, int h, int w, int H, int W, int ignore,   \
                      int rows, void* part_sum, void* part_cnt,               \
                      void* loss_out, void* n_out, void* stream) {            \
    return launch_fwd<T>(logits, labels, lo_y, hi_y, ty, hi_x, tx, xr, B, C,  \
                         h, w, H, W, ignore, rows, part_sum, part_cnt,        \
                         loss_out, n_out, stream);                            \
  }

#define FUSED_CE_BWD(NAME, T)                                                  \
  extern "C" int NAME(const void* logits, const void* labels,                 \
                      const void* lo_y, const void* hi_y, const void* ty,     \
                      const void* hi_x, const void* tx, const void* xr,       \
                      const void* band_y, const void* g, const void* n,       \
                      int B, int C, int h, int w, int H, int W, int ignore,   \
                      int k, int rpp, void* edge_e, void* edge_f, void* dx,   \
                      void* stream) {                                         \
    return launch_bwd<T>(logits, labels, lo_y, hi_y, ty, hi_x, tx, xr,        \
                         band_y, g, n, B, C, h, w, H, W, ignore, k, rpp,      \
                         edge_e, edge_f, dx, stream);                         \
  }

// The geometry the wrapper must share, read by it once at load.
extern "C" int fused_ce_threads() { return kThreads; }
extern "C" int fused_ce_bwd_smem_bytes(int C, int w, int k, int rpp) {
  return bwd_smem_bytes(C, w, k, rpp);
}

FUSED_CE_FWD(fused_ce_fwd_f32, float)
FUSED_CE_FWD(fused_ce_fwd_bf16, __nv_bfloat16)
FUSED_CE_BWD(fused_ce_bwd_f32, float)
FUSED_CE_BWD(fused_ce_bwd_bf16, __nv_bfloat16)
