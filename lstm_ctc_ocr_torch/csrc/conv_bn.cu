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
// the card's 295 FLOP per byte in bf16: the products belong on the tensor
// cores.
//
// Design: the TPU kernel kept the whole batch's activations in VMEM between
// its conv phase and its normalise phase, on a grid that runs in order (25
// MB at batch 256). An H100 block holds 227 KB and blocks run in no order,
// so the work is three kernels behind the one entry point, with y making
// one round trip through device memory (L2 holds it at these sizes):
//  1. the conv, an implicit GEMM: rows m = (n, w, h), columns co, depth
//     K = 9 taps x Ci. Its epilogue adds the bias, rounds once, writes y,
//     and reduces the tile's rounded values to one sum and one sum of
//     squares per column, written to part[row tile][2][Co].
//     bf16: conv_bn_conv_mma_kernel, tensor cores. mma.sync m16n8k16 (bf16
//     in, f32 accumulators) and not wgmma: the A operand is a gather of
//     shifted image rows whose out-of-image rows must read as zeros, which
//     cp.async's zero-fill gives per 16-byte chunk with no branch per
//     element, and a 128x128 tile of mma.sync keeps this first tensor-core
//     version simple (no TMA descriptors, no warpgroup sync) while it lifts
//     the products off the CUDA cores; wgmma is the next step if the conv
//     becomes the limit. A block of 256 threads (8 warps, 2 x 4, 64 x 32
//     outputs each) computes a 128 (rows) x 128 (columns) tile: 48 x 4 =
//     192 tiles at conv4_1/conv4_2, batch 64, two blocks an SM. The depth
//     goes in steps of 32 channels of one tap -- a step never crosses a
//     tap, so the A tile is that tap's shifted rows of channels-last x,
//     and channels past Ci (a Ci that is not a multiple of 32) and rows
//     outside the image are zero-filled by the copy itself (cp.async with
//     src-size 0). A and B ([9][Co][Ci] taps, so a column's depth is
//     contiguous like a row's) come through a 3-stage cp.async ring and
//     ldmatrix, rows padded to 80 bytes so ldmatrix meets no bank conflict.
//     f32: conv_bn_conv_kernel, FP32 FMAs on CUDA cores (no TF32): one
//     64x64 tile per block of 256 threads (4x4 per thread), 16 input
//     channels of one tap per shared-memory step, taps [9][Ci][Co].
//  2. conv_bn_stats_kernel: one thread per channel adds the row tiles'
//     partials in ascending order and derives scale and shift.
//  3. conv_bn_norm_kernel: y <- relu(y * scale + shift), in place.
// Before them the entry point launches the layout work the wrapper would
// otherwise do with torch ops on the host: conv_bn_layout_kernel makes x
// channels-last (skipped when it already is) and conv_bn_taps_kernel casts
// and reorders the 3x3 kernel into the taps. Both, part and scale_shift live
// in one scratch buffer whose layout (and so the row tile) this file alone
// decides: conv_bn_scratch_bytes tells the wrapper its size.
// Every sum has a fixed order (no atomics, no split-K; the column sums of a
// tile go thread, warp butterfly, then warp rows in order), so two runs
// agree bit for bit.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/conv_bn_cuda.py). The entry points launch on the
// given stream, do not synchronise, and return cudaGetLastError().

#include "lstm_common.cuh"

namespace {

using lstm_common::from_f32;
using lstm_common::to_f32;

constexpr int kTile = 64;    // f32: output tile edge (rows and columns)
constexpr int kStep = 16;    // input channels per shared-memory step

// bf16 tensor-core conv
constexpr int kMmaRows = 128;                 // output tile: rows m
constexpr int kMmaCols = 128;                 //              columns co
constexpr int kMmaDepth = 32;                 // channels of one tap per stage
constexpr int kMmaStages = 3;
constexpr int kMmaPitch = kMmaDepth + 8;      // bf16 per smem row (80 bytes)
constexpr int kMmaThreads = 256;
constexpr size_t kMmaSmem =
    (size_t)kMmaStages * (kMmaRows + kMmaCols) * kMmaPitch * 2 +
    (size_t)2 * 2 * kMmaCols * sizeof(float);

__global__ void __launch_bounds__(kMmaThreads, 2)
conv_bn_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ taps,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ part, int n_img, int w, int h,
                        int ci, int co) {
  using bf16 = __nv_bfloat16;
  using lstm_common::cp_async16;
  using lstm_common::smem_addr;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);           // [stage][row][pitch]
  bf16* b_s = a_s + kMmaStages * kMmaRows * kMmaPitch;  // [stage][col][pitch]
  // red: [warp row 0..1][sum, sum of squares][column]
  float* red =
      reinterpret_cast<float*>(b_s + kMmaStages * kMmaCols * kMmaPitch);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wr = (warp / 4) * 64, wc = (warp % 4) * 32;   // warp's outputs
  const long long m_total = (long long)n_img * w * h;
  const long long m0 = (long long)blockIdx.y * kMmaRows;
  const int c0 = blockIdx.x * kMmaCols;

  // this thread's two 16-byte chunks of each tile: row (or column) and depth
  int ld_row[2], ld_chunk[2], pix_w[2], pix_h[2];
  long long pix_n[2];
  bool row_ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int idx = tid + e * kMmaThreads;
    ld_row[e] = idx / 4;
    ld_chunk[e] = (idx % 4) * 8;
    const long long m = m0 + ld_row[e];
    row_ok[e] = m < m_total;
    pix_h[e] = (int)(m % h);
    pix_w[e] = (int)((m / h) % w);
    pix_n[e] = m / ((long long)w * h);
  }
  const int steps_per_tap = (ci + kMmaDepth - 1) / kMmaDepth;
  const int steps = 9 * steps_per_tap;

  auto load = [&](int stage, int step) {
    const int tap = step / steps_per_tap;
    const int ci0 = (step % steps_per_tap) * kMmaDepth;
    const int dw = tap / 3 - 1, dh = tap % 3 - 1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = ci0 + ld_chunk[e];
      const int w2 = pix_w[e] + dw, h2 = pix_h[e] + dh;
      const bool ok_a = row_ok[e] && ch < ci && w2 >= 0 && w2 < w && h2 >= 0 &&
                        h2 < h;
      const bf16* src_a =
          ok_a ? x + ((pix_n[e] * w + w2) * h + h2) * ci + ch : x;
      cp_async16(smem_addr(a_s + (stage * kMmaRows + ld_row[e]) * kMmaPitch +
                           ld_chunk[e]),
                 src_a, ok_a);
      const int col = c0 + ld_row[e];
      const bool ok_b = col < co && ch < ci;
      const bf16* src_b =
          ok_b ? taps + ((long long)tap * co + col) * ci + ch : taps;
      cp_async16(smem_addr(b_s + (stage * kMmaCols + ld_row[e]) * kMmaPitch +
                           ld_chunk[e]),
                 src_b, ok_b);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < steps) load(s, s);
    lstm_common::cp_async_commit();
  }
  const int mi = lane / 8, mj = lane % 8;    // ldmatrix: matrix, row in it
  for (int s = 0; s < steps; ++s) {
    lstm_common::cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int next = s + kMmaStages - 1;
    if (next < steps) load(next % kMmaStages, next);
    lstm_common::cp_async_commit();
    const bf16* a_st = a_s + (s % kMmaStages) * kMmaRows * kMmaPitch;
    const bf16* b_st = b_s + (s % kMmaStages) * kMmaCols * kMmaPitch;
#pragma unroll
    for (int kk = 0; kk < kMmaDepth; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lstm_common::ldmatrix_x4(
            af[i], smem_addr(a_st + (wr + i * 16 + lane % 16) * kMmaPitch +
                             kk + (lane / 16) * 8));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        lstm_common::ldmatrix_x4(
            bf[p], smem_addr(b_st + (wc + p * 16 + (mi / 2) * 8 + mj) *
                                        kMmaPitch + kk + (mi % 2) * 8));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lstm_common::mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                                bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  lstm_common::cp_async_wait<0>();

  // bias, the one rounding, y, and this thread's column sums over its rows
  // (i, then the row half, ascending)
  float cs[4][2], cq[4][2];
  float bias_v[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = c0 + wc + j * 8 + (lane % 4) * 2 + p;
      bias_v[j][p] = col < co ? bias[col] : 0.0f;
      cs[j][p] = 0.0f;
      cq[j][p] = 0.0f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wr + i * 16 + lane / 4 + half * 8;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + wc + j * 8 + (lane % 4) * 2;
        const __nv_bfloat162 r2 = __floats2bfloat162_rn(
            acc[i][j][half * 2] + bias_v[j][0],
            acc[i][j][half * 2 + 1] + bias_v[j][1]);
        bf16* dst = y + m * co + col;
        if (col + 1 < co && (co % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = r2;
        } else {
          if (col < co) dst[0] = r2.x;
          if (col + 1 < co) dst[1] = r2.y;
        }
        const float r0 = col < co ? __bfloat162float(r2.x) : 0.0f;
        const float r1 = col + 1 < co ? __bfloat162float(r2.y) : 0.0f;
        cs[j][0] += r0;
        cq[j][0] += r0 * r0;
        cs[j][1] += r1;
        cq[j][1] += r1 * r1;
      }
    }
  // over the warp's 8 row groups (lanes with the same lane % 4)
#pragma unroll
  for (int off = 4; off < 32; off *= 2)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        cs[j][p] += __shfl_xor_sync(0xffffffffu, cs[j][p], off);
        cq[j][p] += __shfl_xor_sync(0xffffffffu, cq[j][p], off);
      }
  if (lane < 4) {
    float* red_w = red + (warp / 4) * 2 * kMmaCols;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = wc + j * 8 + lane * 2 + p;
        red_w[c] = cs[j][p];
        red_w[kMmaCols + c] = cq[j][p];
      }
  }
  __syncthreads();
  if (tid < kMmaCols && c0 + tid < co) {
    float* dst = part + (long long)blockIdx.y * 2 * co;
    dst[c0 + tid] = red[tid] + red[2 * kMmaCols + tid];
    dst[co + c0 + tid] = red[kMmaCols + tid] + red[3 * kMmaCols + tid];
  }
}

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

// The wrapper's layout work, as two launches inside the entry point.
// x [N][Ci][W H] (the port's [N, C, W, H]) -> x_cl [N][W H][Ci]: 32 x 32
// tiles through shared memory, both sides coalesced.
template <typename T>
__global__ void __launch_bounds__(256)
conv_bn_layout_kernel(const T* __restrict__ x, T* __restrict__ x_cl, int ci,
                      int wh) {
  __shared__ T tile[32][33];
  const long long base = (long long)blockIdx.z * ci * wh;
  const int c0 = blockIdx.y * 32, p0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;   // 32 x 8
  for (int i = ty; i < 32; i += 8)
    if (c0 + i < ci && p0 + tx < wh)
      tile[i][tx] = x[base + (long long)(c0 + i) * wh + p0 + tx];
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    if (p0 + i < wh && c0 + tx < ci)
      x_cl[base + (long long)(p0 + i) * ci + c0 + tx] = tile[tx][i];
}

// The taps from the f32 kernel [Co][Ci][3][3], cast once: [9][Co][Ci] for
// bf16 (each output channel's depth contiguous, the B operand of the
// tensor-core product), [9][Ci][Co] for f32. One thread per (co, ci) pair
// reads its nine contiguous entries; in bf16 a warp's writes to each tap
// are contiguous too.
template <typename T> __host__ __device__ constexpr bool taps_co_major();
template <> __host__ __device__ constexpr bool taps_co_major<float>() {
  return false;
}
template <> __host__ __device__ constexpr bool taps_co_major<__nv_bfloat16>() {
  return true;
}

template <typename T>
__global__ void __launch_bounds__(256)
conv_bn_taps_kernel(const float* __restrict__ kernel, T* __restrict__ taps,
                    int ci, int co) {
  const long long per_tap = (long long)ci * co;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per_tap; i += stride) {                  // i = co_index * Ci + ci
    const long long dst = taps_co_major<T>() ? i : (i % ci) * co + i / ci;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      taps[tap * per_tap + dst] = from_f32<T>(kernel[i * 9 + tap]);
  }
}

template <typename T> constexpr int row_tile();
template <> constexpr int row_tile<float>() { return kTile; }
template <> constexpr int row_tile<__nv_bfloat16>() { return kMmaRows; }

// One scratch buffer holds, 256-byte aligned: x_cl (when x is not channels
// last already), the taps, the per-tile statistics part[n_tiles][2][Co] and
// scale_shift[2][Co].
struct Scratch {
  size_t x_cl, taps, part, scale_shift, bytes;
};

template <typename T>
Scratch scratch_layout(int n_img, int w, int h, int ci, int co,
                       bool x_channels_last) {
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  const size_t m_total = (size_t)n_img * w * h;
  const size_t n_tiles = (m_total + row_tile<T>() - 1) / row_tile<T>();
  Scratch s;
  s.x_cl = 0;
  s.taps = x_channels_last ? 0 : up(m_total * ci * sizeof(T));
  s.part = s.taps + up((size_t)9 * ci * co * sizeof(T));
  s.scale_shift = s.part + up(n_tiles * 2 * co * sizeof(float));
  s.bytes = s.scale_shift + up((size_t)2 * co * sizeof(float));
  return s;
}

// The conv phase: FP32 FMAs for f32, tensor cores for bf16.
int launch_conv(const float* x, const float* taps, const float* bias,
                float* y, float* part, int n_img, int w, int h, int ci, int co,
                int n_tiles, cudaStream_t stream) {
  conv_bn_conv_kernel<float>
      <<<dim3((co + kTile - 1) / kTile, n_tiles), 256, 0, stream>>>(
          x, taps, bias, y, part, n_img, w, h, ci, co);
  return (int)cudaGetLastError();
}

int launch_conv(const __nv_bfloat16* x, const __nv_bfloat16* taps,
                const float* bias, __nv_bfloat16* y, float* part, int n_img,
                int w, int h, int ci, int co, int n_tiles,
                cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bn_conv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMmaSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  conv_bn_conv_mma_kernel<<<dim3((co + kMmaCols - 1) / kMmaCols, n_tiles),
                            kMmaThreads, kMmaSmem, stream>>>(
      x, taps, bias, y, part, n_img, w, h, ci, co);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, int x_channels_last, const void* kernel,
           const void* bias, const void* gamma, const void* beta, void* y,
           void* scratch, int n_img, int w, int h, int ci, int co, float eps,
           void* stream_ptr) {
  if (n_img <= 0 || w <= 0 || h <= 0 || co <= 0 || ci <= 0 || ci % kStep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Scratch s =
      scratch_layout<T>(n_img, w, h, ci, co, x_channels_last != 0);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const T* x_cl = static_cast<const T*>(x);
  if (!x_channels_last) {
    T* dst = reinterpret_cast<T*>(base + s.x_cl);
    conv_bn_layout_kernel<T>
        <<<dim3((w * h + 31) / 32, (ci + 31) / 32, n_img), 256, 0, stream>>>(
            static_cast<const T*>(x), dst, ci, w * h);
    x_cl = dst;
  }
  T* taps = reinterpret_cast<T*>(base + s.taps);
  const long long pairs = (long long)ci * co;
  conv_bn_taps_kernel<T><<<(int)((pairs + 255) / 256 < 132 * 8
                                     ? (pairs + 255) / 256
                                     : 132 * 8),
                           256, 0, stream>>>(
      static_cast<const float*>(kernel), taps, ci, co);
  float* part = reinterpret_cast<float*>(base + s.part);
  float* scale_shift = reinterpret_cast<float*>(base + s.scale_shift);
  const long long m_total = (long long)n_img * w * h;
  const int n_tiles = (int)((m_total + row_tile<T>() - 1) / row_tile<T>());
  cudaError_t err = (cudaError_t)launch_conv(
      x_cl, taps, static_cast<const float*>(bias), static_cast<T*>(y), part,
      n_img, w, h, ci, co, n_tiles, stream);
  if (err != cudaSuccess) return (int)err;
  conv_bn_stats_kernel<<<(co + 255) / 256, 256, 0, stream>>>(
      part, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      scale_shift, n_tiles, co, 1.0f / (float)m_total, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = m_total * co;
  const int blocks = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                          : 132 * 16);
  conv_bn_norm_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<T*>(y), scale_shift, total, co);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch the entry point for the type (bf16 != 0) needs at this
// shape; x_channels_last != 0 when x is already [N, W, H, Ci] in memory.
extern "C" long long conv_bn_scratch_bytes(int bf16, int n_img, int w, int h,
                                           int ci, int co,
                                           int x_channels_last) {
  return (long long)(bf16 ? scratch_layout<__nv_bfloat16>(
                                n_img, w, h, ci, co, x_channels_last != 0)
                          : scratch_layout<float>(n_img, w, h, ci, co,
                                                  x_channels_last != 0))
      .bytes;
}

// Dynamic shared memory of one bf16 conv block, in bytes (for reports).
extern "C" int conv_bn_mma_smem() { return (int)kMmaSmem; }

// x: [N, Ci, W, H] (x_channels_last == 0) or [N, W, H, Ci] (!= 0) in the
// element type; kernel: [Co, Ci, 3, 3] f32; bias, gamma, beta: [Co] f32; y
// (output, also the conv's scratch): [N, W, H, Co]; scratch:
// conv_bn_scratch_bytes(...) bytes, 256-byte aligned. Ci must be a multiple
// of 16. Launches, in order: the layout of x (when needed), the taps, the
// conv, the statistics, the normalisation. Returns a cudaError_t.
extern "C" int conv_bn_bf16(const void* x, int x_channels_last,
                            const void* kernel, const void* bias,
                            const void* gamma, const void* beta, void* y,
                            void* scratch, int n_img, int w, int h, int ci,
                            int co, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, x_channels_last, kernel, bias, gamma, beta,
                               y, scratch, n_img, w, h, ci, co, eps, stream);
}

extern "C" int conv_bn_f32(const void* x, int x_channels_last,
                           const void* kernel, const void* bias,
                           const void* gamma, const void* beta, void* y,
                           void* scratch, int n_img, int w, int h, int ci,
                           int co, float eps, void* stream) {
  return launch<float>(x, x_channels_last, kernel, bias, gamma, beta, y,
                       scratch, n_img, w, h, ci, co, eps, stream);
}
