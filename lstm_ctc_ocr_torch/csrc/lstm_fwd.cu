// Masked unidirectional LSTM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel lstm_ctc_ocr_tpu/ops/rnn_pallas.py:_fwd_kernel
// (called through _fwd_call): the recurrence of the stacked `lstm` head and
// of each scan of the two-scan BiLSTM pair. A row whose length is <= t
// leaves its state untouched and writes a zero output.
//
// Per step the math is, with g = x_proj[t] + h_{t-1} U + b:
//   i = sigmoid(g_i), j = tanh(g_j), f = sigmoid(g_f + forget_bias),
//   o = sigmoid(g_o), c = f c + i j, h = o tanh(c)          (gate order i,j,f,o)
// h and c are carried in f32; h enters the product rounded to the input
// type, as the TPU kernel casts it; products accumulate in f32. With
// residuals on it also writes the post-activation gates and the masked h
// and c carries, which lstm_bwd.cu reads.
//
// What bounds it on an H100: a serial chain of T dependent steps, each a
// [rows, H] x [H, 4H] product. The stacked head runs H = 512 (twice the
// BiLSTM's per-direction width): U is 2 MB in bf16 and 4 MB in f32, nine to
// eighteen times a block's 227 KB of shared memory, so U stays in global
// memory and every block re-reads it from L2 each step; the FP32 FMAs of
// the product (H * 4H per row and step) run on CUDA cores.
//
// Design: the TPU carried h/c in VMEM scratch across a sequential grid of
// time blocks, with the time and batch axes padded to its tiles; here the
// time loop lives inside the block and nothing is padded. One block per
// batch row, H threads (up to 512, so at most 128 registers a thread):
// thread k owns hidden unit k, computes its four gate columns k, H+k, 2H+k,
// 3H+k, and keeps that unit's h and c in registers, so the gate math and
// the state update are thread-local. The row's h sits in shared memory,
// two __syncthreads per step. The wrapper hands U packed as
// [H/VEC][4H][VEC] (VEC = 16 bytes of the element type), so one 16-byte load
// per thread and gate brings VEC consecutive rows of U and a warp's loads
// cover 512 contiguous bytes; the loop over those loads is unrolled 4 deep
// to keep several in flight. Batch 64 fills 64 of the 132 SMs; splitting
// U over a cluster's shared memory and tensor-core products are the next
// step, as for bilstm_fwd.cu.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include "lstm_common.cuh"

namespace {

using lstm_common::from_f32;
using lstm_common::sigmoid_f32;
using lstm_common::to_f32;

constexpr int kMaxHidden = 512;  // H: threads per block

template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ u,
                const T* __restrict__ bias, const int* __restrict__ lens,
                T* __restrict__ out, T* __restrict__ g_out,
                T* __restrict__ h_out, T* __restrict__ c_out,
                int t_len, int n_rows, int hid, float forget_bias) {
  constexpr int VEC = 16 / sizeof(T);
  const bool save = g_out != nullptr;
  const int k = threadIdx.x;                     // hidden unit
  const int n = blockIdx.x;                      // batch row
  const int four_h = 4 * hid;
  const int len = lens[n];

  extern __shared__ float h_row[];               // [hid], compute-rounded h

  float h = 0.0f, c = 0.0f;
  h_row[k] = 0.0f;
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = to_f32(bias[g * hid + k]);
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const long long row = (long long)t * n_rows + n;
    const T* x_row = xp + row * four_h;
    float acc[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[g] = to_f32(x_row[g * hid + k]);

    // acc[g] += sum_kk h_row[kk] * U[kk][g*hid + k]
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
        const float hv = h_row[kb * VEC + v];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[g] = fmaf(hv, to_f32(uv[g][v]), acc[g]);
      }
    }

    const float gi = sigmoid_f32(acc[0] + b[0]);
    const float gj = tanhf(acc[1] + b[1]);
    const float gfo = sigmoid_f32(acc[2] + b[2] + forget_bias);
    const float go = sigmoid_f32(acc[3] + b[3]);
    const float c_new = gfo * c + gi * gj;
    const float h_new = go * tanhf(c_new);
    const bool live = len > t;
    if (live) {
      h = h_new;
      c = c_new;
    }
    out[row * hid + k] = from_f32<T>(live ? h_new : 0.0f);
    if (save) {
      T* g_row = g_out + row * four_h;
      g_row[k] = from_f32<T>(gi);
      g_row[hid + k] = from_f32<T>(gj);
      g_row[2 * hid + k] = from_f32<T>(gfo);
      g_row[3 * hid + k] = from_f32<T>(go);
      h_out[row * hid + k] = from_f32<T>(h);
      c_out[row * hid + k] = from_f32<T>(c);
    }
    __syncthreads();                             // all reads of h_row done
    h_row[k] = to_f32(from_f32<T>(h));
    __syncthreads();
  }
}

template <typename T>
int launch(const void* xp, const void* u, const void* bias, const void* lens,
           void* out, void* g_out, void* h_out, void* c_out, int t_len,
           int n_rows, int hid, float forget_bias, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden ||
      hid % VEC != 0)
    return (int)cudaErrorInvalidValue;
  lstm_fwd_kernel<T><<<n_rows, hid, sizeof(float) * hid,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(u),
      static_cast<const T*>(bias), static_cast<const int*>(lens),
      static_cast<T*>(out), static_cast<T*>(g_out), static_cast<T*>(h_out),
      static_cast<T*>(c_out), t_len, n_rows, hid, forget_bias);
  return (int)cudaGetLastError();
}

}  // namespace

// xp: [T, N, 4H] contiguous; u: U packed as [H/VEC][4H][VEC]; bias: [4H];
// lens: [N] int32; out: [T, N, H]. g_out ([T, N, 4H]), h_out and c_out
// ([T, N, H]) are null unless residuals are saved. Returns a cudaError_t.
extern "C" int lstm_fwd_bf16(const void* xp, const void* u, const void* bias,
                             const void* lens, void* out, void* g_out,
                             void* h_out, void* c_out, int t_len, int n_rows,
                             int hid, float forget_bias, void* stream) {
  return launch<__nv_bfloat16>(xp, u, bias, lens, out, g_out, h_out, c_out,
                               t_len, n_rows, hid, forget_bias, stream);
}

extern "C" int lstm_fwd_f32(const void* xp, const void* u, const void* bias,
                            const void* lens, void* out, void* g_out,
                            void* h_out, void* c_out, int t_len, int n_rows,
                            int hid, float forget_bias, void* stream) {
  return launch<float>(xp, u, bias, lens, out, g_out, h_out, c_out, t_len,
                       n_rows, hid, forget_bias, stream);
}
