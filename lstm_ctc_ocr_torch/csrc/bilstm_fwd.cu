// Fused masked bidirectional LSTM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel lstm_ctc_ocr_tpu/ops/rnn_pallas.py:_bi_fwd_kernel
// (called through _bi_fwd_call). Both directions run in one launch: the
// forward direction walks physical time ascending, the backward direction
// descending, and a row whose length is <= t leaves its state untouched and
// writes a zero output. That masked descending walk equals running the
// backward cell over the length-reversed sequence (tf.reverse_sequence), so
// no reversal gathers are needed.
//
// Per step and direction the math is, with g = x_proj[t] + h_{t-1} U + b:
//   i = sigmoid(g_i), j = tanh(g_j), f = sigmoid(g_f + forget_bias),
//   o = sigmoid(g_o), c = f c + i j, h = o tanh(c)          (gate order i,j,f,o)
// h and c are carried in f32; h enters the product rounded to the input
// type, as the TPU kernel casts it; products accumulate in f32.
//
// What bounds it on an H100: a serial chain of T dependent steps, each a
// [rows, H] x [H, 4H] product per direction. At H = 256, U is 512 KB (bf16)
// per direction, more than a block's 227 KB of shared memory, so U stays in
// global memory and is re-read from L2 every step; the FP32 FMAs of the
// product (rows * H * 4H per step) run on CUDA cores, not tensor cores.
//
// Design: the TPU carried h/c in VMEM scratch across a sequential grid; on
// the GPU blocks run in parallel and in no order, so the time loop lives
// inside the block. One block per (batch tile of NB rows, direction), H
// threads: thread k owns hidden unit k, computes its four gate columns
// k, H+k, 2H+k, 3H+k for the tile's rows, and keeps that unit's h and c in
// registers, so the gate math and the state update are thread-local. The
// tile's h sits in shared memory, with two __syncthreads per step. The
// wrapper hands U in a packed layout [H/VEC][4H][VEC] (VEC = 16 bytes of the
// element type), so one 16-byte load per thread and gate brings VEC
// consecutive rows of U and a warp's loads cover 512 contiguous bytes; the
// loop over those loads is unrolled 4 deep to keep several in flight.
// NB = 1 spreads batch 64 over 128 blocks (both directions) of H = 256
// threads, which spreads the FMAs over nearly all 132 SMs, at the price of
// every block pulling all of U from L2 each step. A sweep over NB in
// {1, 2, 4, 8}, launch bounds and unrolling on an H100 chose these values;
// U split across a cluster's shared memory and tensor-core products are
// the next step.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 1;   // NB: batch rows per block
constexpr int kMaxHidden = 256;  // H: threads per block

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

template <typename T, int NB>
__global__ void __launch_bounds__(kMaxHidden)
bilstm_fwd_kernel(const T* __restrict__ xpf, const T* __restrict__ xpb,
                  long long x_row_stride,
                  const T* __restrict__ uf, const T* __restrict__ ub,
                  const T* __restrict__ bf, const T* __restrict__ bb,
                  const int* __restrict__ lens,
                  T* __restrict__ of, T* __restrict__ ob,
                  T* __restrict__ gf, T* __restrict__ gb,
                  T* __restrict__ hf, T* __restrict__ hb,
                  T* __restrict__ cf, T* __restrict__ cb,
                  int t_len, int n_rows, int hid, float forget_bias) {
  constexpr int VEC = 16 / sizeof(T);
  const int dir = blockIdx.y;                    // 0: forward, 1: backward
  const T* __restrict__ xp = dir ? xpb : xpf;
  const T* __restrict__ u = dir ? ub : uf;
  const T* __restrict__ bias = dir ? bb : bf;
  T* __restrict__ out = dir ? ob : of;
  T* __restrict__ g_out = dir ? gb : gf;
  T* __restrict__ h_out = dir ? hb : hf;
  T* __restrict__ c_out = dir ? cb : cf;
  const bool save = g_out != nullptr;

  const int k = threadIdx.x;                     // hidden unit
  const int n0 = blockIdx.x * NB;
  const int four_h = 4 * hid;

  extern __shared__ float h_tile[];              // [NB][hid], compute-rounded h

  float h[NB], c[NB];
  int len[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    h[r] = 0.0f;
    c[r] = 0.0f;
    len[r] = (n0 + r < n_rows) ? lens[n0 + r] : 0;
    h_tile[r * hid + k] = 0.0f;
  }
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = to_f32(bias[g * hid + k]);
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = dir ? t_len - 1 - s : s;
    float acc[4][NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const int n = n0 + r;
      const T* x_row = xp + ((long long)t * n_rows + n) * x_row_stride;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g][r] = (n < n_rows) ? to_f32(x_row[g * hid + k]) : 0.0f;
    }

    // acc[g][r] += sum_kk h_tile[r][kk] * U[kk][g*hid + k]
#pragma unroll 4
    for (int kb = 0; kb < hid / VEC; ++kb) {
      alignas(16) T uv[4][VEC];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint4* src = reinterpret_cast<const uint4*>(
            u + ((long long)kb * four_h + g * hid + k) * VEC);
        *reinterpret_cast<uint4*>(uv[g]) = __ldg(src);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float uu[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) uu[g] = to_f32(uv[g][v]);
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          const float hv = h_tile[r * hid + kb * VEC + v];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hv, uu[g], acc[g][r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const int n = n0 + r;
      const float gi = sigmoid_f32(acc[0][r] + b[0]);
      const float gj = tanhf(acc[1][r] + b[1]);
      const float gfo = sigmoid_f32(acc[2][r] + b[2] + forget_bias);
      const float go = sigmoid_f32(acc[3][r] + b[3]);
      const float c_new = gfo * c[r] + gi * gj;
      const float h_new = go * tanhf(c_new);
      const bool live = len[r] > t;
      if (live) {
        h[r] = h_new;
        c[r] = c_new;
      }
      if (n < n_rows) {
        const long long row = (long long)t * n_rows + n;
        out[row * hid + k] = from_f32<T>(live ? h_new : 0.0f);
        if (save) {
          T* g_row = g_out + row * four_h;
          g_row[k] = from_f32<T>(gi);
          g_row[hid + k] = from_f32<T>(gj);
          g_row[2 * hid + k] = from_f32<T>(gfo);
          g_row[3 * hid + k] = from_f32<T>(go);
          h_out[row * hid + k] = from_f32<T>(h[r]);
          c_out[row * hid + k] = from_f32<T>(c[r]);
        }
      }
    }
    __syncthreads();                             // all reads of h_tile done
#pragma unroll
    for (int r = 0; r < NB; ++r)
      h_tile[r * hid + k] = to_f32(from_f32<T>(h[r]));
    __syncthreads();
  }
}

template <typename T>
int launch(const void* xpf, const void* xpb, long long x_row_stride,
           const void* uf, const void* ub, const void* bf, const void* bb,
           const void* lens, void* of, void* ob, void* gf, void* gb,
           void* hf, void* hb, void* cf, void* cb, int t_len, int n_rows,
           int hid, float forget_bias, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden || hid % VEC != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + kTileRows - 1) / kTileRows, 2);
  const size_t smem = sizeof(float) * kTileRows * hid;
  bilstm_fwd_kernel<T, kTileRows>
      <<<grid, hid, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xpf), static_cast<const T*>(xpb),
          x_row_stride, static_cast<const T*>(uf),
          static_cast<const T*>(ub), static_cast<const T*>(bf),
          static_cast<const T*>(bb), static_cast<const int*>(lens),
          static_cast<T*>(of), static_cast<T*>(ob), static_cast<T*>(gf),
          static_cast<T*>(gb), static_cast<T*>(hf), static_cast<T*>(hb),
          static_cast<T*>(cf), static_cast<T*>(cb), t_len, n_rows, hid,
          forget_bias);
  return (int)cudaGetLastError();
}

}  // namespace

// xpf/xpb: [T, N, 4H] rows x_row_stride elements apart; uf/ub: U packed as
// [H/VEC][4H][VEC]; bf/bb: [4H]; lens: [N] int32; of/ob: [T, N, H]. gf/gb
// ([T, N, 4H]), hf/hb and cf/cb ([T, N, H]) are null unless residuals are
// saved. Returns a cudaError_t.
extern "C" int bilstm_fwd_bf16(const void* xpf, const void* xpb,
                               long long x_row_stride, const void* uf,
                               const void* ub, const void* bf, const void* bb,
                               const void* lens, void* of, void* ob, void* gf,
                               void* gb, void* hf, void* hb, void* cf,
                               void* cb, int t_len, int n_rows, int hid,
                               float forget_bias, void* stream) {
  return launch<__nv_bfloat16>(xpf, xpb, x_row_stride, uf, ub, bf, bb, lens,
                               of, ob, gf, gb, hf, hb, cf, cb, t_len, n_rows,
                               hid, forget_bias, stream);
}

extern "C" int bilstm_fwd_f32(const void* xpf, const void* xpb,
                              long long x_row_stride, const void* uf,
                              const void* ub, const void* bf, const void* bb,
                              const void* lens, void* of, void* ob, void* gf,
                              void* gb, void* hf, void* hb, void* cf, void* cb,
                              int t_len, int n_rows, int hid,
                              float forget_bias, void* stream) {
  return launch<float>(xpf, xpb, x_row_stride, uf, ub, bf, bb, lens, of, ob,
                       gf, gb, hf, hb, cf, cb, t_len, n_rows, hid,
                       forget_bias, stream);
}
