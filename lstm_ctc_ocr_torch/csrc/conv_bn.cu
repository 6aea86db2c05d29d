// Fused conv3x3 (SAME) + bias + training-mode batch norm + ReLU forward for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lstm_ctc_ocr_tpu/ops/conv_bn_pallas.py:_kernel
// (called through conv3x3_bn_relu): the forward-only A/B partner of the
// unfused conv4_1 / conv4_2 layers. With x [N, W, H, Ci] (channels last) and
// the nine taps k[dw][dh] of shape [Ci, Co]:
//   acc[m, :] = sum over taps of x[n, w+dw-1, h+dh-1, :] k[dw][dh]   (f32;
//               rows m = (n, w, h), zero outside the image)
//   y = round(acc + bias)                   (once, to the element type)
//   mean = sum(y) / M,  var = max(sum(y^2) / M - mean^2, 0)   (from the
//               ROUNDED y, in f32, one pass, biased, over all M = N W H rows)
//   out = relu(y * scale + shift),  scale = gamma rsqrt(var + eps),
//               shift = beta - mean scale
//
// What bounds it on an H100: operations. conv4_2 at batch 64 is 29 GFLOP
// against 9.4 MB of x and 6.3 MB of output (~2000 FLOP per byte), far above
// the card's 295 FLOP per byte in bf16. This first version runs the products
// as FP32 FMAs on CUDA cores for both element types, so it sits at the CUDA
// cores' rate, not the tensor cores'; a wgmma (or wmma) product for bf16 is
// the next step.
//
// Design: the TPU kernel kept the whole batch's activations in VMEM between
// its conv phase and its normalise phase, on a grid that runs in order (25
// MB at batch 256). An H100 block holds 227 KB and blocks run in no order,
// so the work is three kernels behind the one entry point, with y making
// one round trip through device memory (L2 holds it at these sizes):
//  1. conv_bn_conv_kernel: an implicit GEMM, rows (n, w, h) x columns co
//     over K = 9 taps x Ci. One 64x64 output tile per block of 256 threads
//     (4x4 per thread), 16 input channels of one tap per shared-memory step;
//     a shifted row outside the image loads zeros. The epilogue adds the
//     bias, rounds, writes y, and reduces the tile's rounded values to one
//     sum and one sum of squares per column, written to
//     part[row tile][2][Co].
//  2. conv_bn_stats_kernel: one thread per channel adds the row tiles'
//     partials in ascending order and derives scale and shift.
//  3. conv_bn_norm_kernel: y <- relu(y * scale + shift), in place.
// Every sum has a fixed order (no atomics), so two runs agree bit for bit.
// The f32 path is plain FP32 throughout (no TF32).
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/conv_bn_cuda.py). The entry points launch on the
// given stream, do not synchronise, and return cudaGetLastError().

#include "lstm_common.cuh"

namespace {

using lstm_common::from_f32;
using lstm_common::to_f32;

constexpr int kTile = 64;    // output tile edge (rows and columns)
constexpr int kStep = 16;    // input channels per shared-memory step

template <typename T>
__global__ void __launch_bounds__(256)
conv_bn_conv_kernel(const T* __restrict__ x, const T* __restrict__ taps,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ part, int n_img, int w, int h, int ci,
                    int co) {
  __shared__ float a_s[kStep][kTile + 1];        // [channel][row], padded
  __shared__ float b_s[kStep][kTile];            // [channel][column]
  __shared__ float red_s[16][kTile];             // column sums per thread row
  __shared__ float red_q[16][kTile];             // column sums of squares

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;        // 16 x 16 threads, 4 x 4 each
  const long long m_total = (long long)n_img * w * h;
  const long long m0 = (long long)blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  // this thread's cells of the two loads
  const int a_row = tid / 4, a_ch = (tid % 4) * 4;
  const int b_ch = tid / 16, b_col = (tid % 16) * 4;
  const long long m_load = m0 + a_row;
  const bool m_ok = m_load < m_total;
  const int hh = (int)(m_load % h);
  const int ww = (int)((m_load / h) % w);
  const long long nn = m_load / ((long long)w * h);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int w2 = ww + tap / 3 - 1, h2 = hh + tap % 3 - 1;
    const bool inside = m_ok && w2 >= 0 && w2 < w && h2 >= 0 && h2 < h;
    const T* src = x + ((nn * w + w2) * h + h2) * ci;   // read only if inside
    const T* k_tap = taps + (long long)tap * ci * co;
    for (int ci0 = 0; ci0 < ci; ci0 += kStep) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_s[a_ch + e][a_row] = inside ? to_f32(src[ci0 + a_ch + e]) : 0.0f;
        const int col = c0 + b_col + e;
        b_s[b_ch][b_col + e] =
            col < co ? to_f32(k_tap[(long long)(ci0 + b_ch) * co + col]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // bias, the one rounding, y, and this thread's column sums over its rows
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (m < m_total && col < co) {
        const T r = from_f32<T>(acc[i][j] + bias[col]);
        y[m * co + col] = r;
        const float rf = to_f32(r);
        cs[j] += rf;
        cq[j] += rf * rf;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty][tx * 4 + j] = cs[j];
    red_q[ty][tx * 4 + j] = cq[j];
  }
  __syncthreads();
  if (tid < kTile && c0 + tid < co) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      s += red_s[r][tid];
      q += red_q[r][tid];
    }
    float* dst = part + (long long)blockIdx.y * 2 * co;
    dst[c0 + tid] = s;
    dst[co + c0 + tid] = q;
  }
}

__global__ void __launch_bounds__(256)
conv_bn_stats_kernel(const float* __restrict__ part,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     float* __restrict__ scale_shift, int n_tiles, int co,
                     float inv_count, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= co) return;
  float s = 0.0f, q = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    s += part[(long long)t * 2 * co + c];
    q += part[(long long)t * 2 * co + co + c];
  }
  const float mean = s * inv_count;
  const float var = fmaxf(q * inv_count - mean * mean, 0.0f);
  const float scale = gamma[c] * rsqrtf(var + eps);
  scale_shift[c] = scale;
  scale_shift[co + c] = beta[c] - mean * scale;
}

template <typename T>
__global__ void __launch_bounds__(256)
conv_bn_norm_kernel(T* __restrict__ y, const float* __restrict__ scale_shift,
                    long long total, int co) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = (int)(i % co);
    const float v = to_f32(y[i]) * scale_shift[c] + scale_shift[co + c];
    y[i] = from_f32<T>(fmaxf(v, 0.0f));
  }
}

template <typename T>
int launch(const void* x, const void* taps, const void* bias,
           const void* gamma, const void* beta, void* y, void* part,
           void* scale_shift, int n_img, int w, int h, int ci, int co,
           float eps, void* stream_ptr) {
  if (n_img <= 0 || w <= 0 || h <= 0 || co <= 0 || ci <= 0 || ci % kStep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long m_total = (long long)n_img * w * h;
  const int n_tiles = (int)((m_total + kTile - 1) / kTile);
  conv_bn_conv_kernel<T>
      <<<dim3((co + kTile - 1) / kTile, n_tiles), 256, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(taps),
          static_cast<const float*>(bias), static_cast<T*>(y),
          static_cast<float*>(part), n_img, w, h, ci, co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv_bn_stats_kernel<<<(co + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(scale_shift),
      n_tiles, co, 1.0f / (float)m_total, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = m_total * co;
  const int blocks = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                          : 132 * 16);
  conv_bn_norm_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<T*>(y), static_cast<const float*>(scale_shift), total, co);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [N, W, H, Ci] channels last; taps: [9, Ci, Co] (tap = 3 dw + dh);
// bias, gamma, beta: [Co] f32; y (output, also the conv's scratch):
// [N, W, H, Co]; part: scratch [ceil(N W H / 64), 2, Co] f32; scale_shift:
// scratch [2, Co] f32. Ci must be a multiple of 16. Returns a cudaError_t.
extern "C" int conv_bn_bf16(const void* x, const void* taps, const void* bias,
                            const void* gamma, const void* beta, void* y,
                            void* part, void* scale_shift, int n_img, int w,
                            int h, int ci, int co, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, taps, bias, gamma, beta, y, part,
                               scale_shift, n_img, w, h, ci, co, eps, stream);
}

extern "C" int conv_bn_f32(const void* x, const void* taps, const void* bias,
                           const void* gamma, const void* beta, void* y,
                           void* part, void* scale_shift, int n_img, int w,
                           int h, int ci, int co, float eps, void* stream) {
  return launch<float>(x, taps, bias, gamma, beta, y, part, scale_shift,
                       n_img, w, h, ci, co, eps, stream);
}
