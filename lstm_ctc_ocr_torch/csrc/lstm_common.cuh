// Pieces shared by the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu, bilstm_bwd.cu):
// conversions between the element type and f32, the sigmoid, and the two
// reductions every LSTM backward ends with: dU = h_prev^T dx as a
// shared-memory tiled product and db as an ordered sum of per-row partials.
// Both are deterministic: fixed summation order, no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_common {

constexpr int kTile = 64;         // dU output tile edge
constexpr int kTileRows = 16;     // dU rows of (t, n) per tile step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One 64x64 tile of du[k][m] = sum_{r < n_k} a[r][k] * b[r][m], with
// a: [n_k, hid] and b: [n_k, four_h], f32 accumulators. Called by a block of
// 256 threads (16 x 16, 4 x 4 outputs each); the tile is (k0, m0).
template <typename T>
__device__ __forceinline__ void du_tile(const T* __restrict__ a,
                                        const T* __restrict__ b,
                                        float* __restrict__ du, long long n_k,
                                        int hid, int four_h, int k0, int m0) {
  __shared__ float a_s[kTileRows][kTile];
  __shared__ float b_s[kTileRows][kTile];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lr = tid / 16, lc = (tid % 16) * 4;  // this thread's load cell

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (long long r0 = 0; r0 < n_k; r0 += kTileRows) {
    const long long r = r0 + lr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + lc + e, mm = m0 + lc + e;
      a_s[lr][lc + e] = (r < n_k && kk < hid) ? to_f32(a[r * hid + kk]) : 0.0f;
      b_s[lr][lc + e] =
          (r < n_k && mm < four_h) ? to_f32(b[r * four_h + mm]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kTileRows; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mm = m0 + tx * 4 + j;
      if (kk < hid && mm < four_h) du[(long long)kk * four_h + mm] = acc[i][j];
    }
  }
}

// db[m] = sum over n (ascending) of part[n][m]; part: [n_rows, four_h].
__device__ __forceinline__ void db_sum(const float* __restrict__ part,
                                       float* __restrict__ db, int n_rows,
                                       int four_h) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= four_h) return;
  float sum = 0.0f;
  for (int n = 0; n < n_rows; ++n) sum += part[(long long)n * four_h + m];
  db[m] = sum;
}

}  // namespace lstm_common
