// The wide recurrences: the LSTM forward and backward walks at hidden sizes
// whose U fits no thread-block cluster, shared by the four LSTM kernels
// (bilstm_fwd.cu, bilstm_bwd.cu: kernels 1 and 2, both directions along the
// grid's y; lstm_fwd.cu, lstm_bwd.cu: kernels 5 and 6, one direction), in
// bf16 and f32. The wrappers (ops/rnn_cuda.py:kernel_path) send them bf16
// above H = 512 (the cluster recurrences' limit: 16 blocks of 32 units
// whose columns of U stay in shared memory, 190 KB and 205 KB a block) and
// f32 at every width (U in f32 would fill a cluster's shared memory at half
// the width, and a tensor-core product would be TF32), up to kMaxHidden.
//
// At H = 1024, U is 8 MB a direction in bf16 and 16 MB in f32: forty to
// seventy times a block's 227 KB of shared memory, but a third of the
// card's 50 MB L2. So U stays in device memory and is streamed from L2
// into the block every step. A block owns one batch row and direction and
// all H units: each thread walks the units k = threadIdx.x, + blockDim.x,
// ... (up to 1024 threads, so any H), computes the four gate columns k,
// H+k, 2H+k, 3H+k of its units over the whole depth, and does their gate
// math. The step's operand row (h_{t-1} in the forward, the rounded dg row
// in the backward) sits in shared memory; the carries (h and c, dh and dc)
// sit beside it, one f32 per unit, read and written only by the unit's
// thread. A block needs no other block: no cluster, no flag in global
// memory, no barrier between blocks, so no launch can wait on a block that
// is not resident, whatever the batch.
//
// U reaches the product packed so that neighbouring threads read
// neighbouring 16 bytes: [H/VEC][4H][VEC] for the forward (VEC = 16 /
// sizeof(T) consecutive rows of one column in 16 bytes) and U^T packed the
// same way, [4H/VEC][H][VEC], for the backward (rnn_cuda._pack_u). The loop
// over those loads is unrolled 4 deep to keep several in flight.
//
// What bounds it: every block reads all of U every step (4 H^2 elements), so
// the step's time is L2 bandwidth: at H = 1024 and batch 64, 128 BiLSTM
// blocks read 1 GB of L2 a step. That is far above the bytes the function
// must move (U once, x_proj and the outputs once); making it fast -- U
// split across the blocks of more than one cluster, with h exchanged
// through distributed shared memory or a flag in global memory -- is left
// to a later change. Right first: the arithmetic, its rounding points and
// the masking are the plain versions' (rnn_cuda._fwd_walk, _bwd_walk), as
// in the first one-block-per-row f32 kernels, whose place it took.
//
// The step, forward (g = x_proj[t] + h_{t-1} U + b, gate order i, j, f, o):
//   i = sigmoid(g_i), j = tanh(g_j), f = sigmoid(g_f + forget_bias),
//   o = sigmoid(g_o), c = f c + i j, h = o tanh(c); a row with len <= t
//   keeps its h and c and writes a zero output. h enters the product
//   rounded to T; products accumulate in f32.
// Backward (the forward's walk reversed; dead steps write dx = 0 and pass
//   dh and dc through):
//   tanh_c = tanh(f c_prev + i j), g_h = dh + dout[t],
//   dc_tot = dc + g_h o (1 - tanh_c^2),
//   dg = [dc_tot j i(1-i), dc_tot i (1-j^2), dc_tot c_prev f(1-f),
//         g_h tanh_c o(1-o)] -> dx[t], rounded to T;
//   dh <- round(dg) U^T, dc <- dc_tot f; db_part[n] += dg (unrounded).
// dU and db come from the kernels' own dU and db launches, as for the
// narrower widths.

#pragma once

#include "lstm_common.cuh"

namespace lstm_wide {

constexpr int kMaxThreads = 1024;
// The backward's shared memory, 6 H floats (dh, dc and the dg row of 4 H),
// stays under a block's 227 KB up to H = 9685; 8192 is the stated limit.
constexpr int kMaxHidden = 8192;

// Threads of a block at hidden size `hid`: one a unit up to 1024.
inline int threads(int hid) {
  const int t = (hid + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Dynamic shared memory, bytes: forward a, h, c [H]; backward dh, dc [H] and
// the dg row [4H], all f32.
inline size_t fwd_smem(int hid) { return sizeof(float) * 3 * (size_t)hid; }
inline size_t bwd_smem(int hid) { return sizeof(float) * 6 * (size_t)hid; }

// Whether the wide kernels take (H, T): 0 < H <= kMaxHidden, H a multiple of
// VEC (the packed loads).
template <typename T>
inline bool shape_ok(int hid) {
  return hid > 0 && hid <= kMaxHidden && hid % (16 / (int)sizeof(T)) == 0;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB only
// after the attribute is raised).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One direction's forward walk over batch row n, run by the whole block.
// xp: [T, N, 4H] rows x_stride elements apart; up: U packed [H/VEC][4H][VEC];
// bias: [4H]; out: [T, N, H]; g_out ([T, N, 4H]), h_out and c_out ([T, N,
// H]) null unless residuals are saved. `reverse` walks t descending (the
// BiLSTM's backward direction).
template <typename T>
__device__ __forceinline__ void fwd_row(
    const T* __restrict__ xp, long long x_stride, const T* __restrict__ up,
    const T* __restrict__ bias, int len, T* __restrict__ out,
    T* __restrict__ g_out, T* __restrict__ h_out, T* __restrict__ c_out,
    int t_len, int n_rows, int n, int hid, float forget_bias, bool reverse) {
  using lstm_common::from_f32;
  using lstm_common::sigmoid_f32;
  using lstm_common::to_f32;
  constexpr int VEC = 16 / sizeof(T);
  const int four_h = 4 * hid;
  const bool save = g_out != nullptr;
  extern __shared__ float wide_smem[];
  float* a_s = wide_smem;          // [H] h_{t-1} as the product takes it
  float* h_s = a_s + hid;          // [H] the h carry, f32
  float* c_s = h_s + hid;          // [H] the c carry
  for (int k = threadIdx.x; k < hid; k += blockDim.x) {
    a_s[k] = 0.0f;
    h_s[k] = 0.0f;
    c_s[k] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = reverse ? t_len - 1 - s : s;
    const bool live = t < len;
    const long long row = (long long)t * n_rows + n;
    const T* x_row = xp + row * x_stride;
    for (int k = threadIdx.x; k < hid; k += blockDim.x) {
      float acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = to_f32(x_row[q * hid + k]);
      // acc[q] += sum_kk a_s[kk] U[kk][q H + k]
#pragma unroll 4
      for (int kb = 0; kb < hid / VEC; ++kb) {
        alignas(16) T uv[4][VEC];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<uint4*>(uv[q]) =
              __ldg(reinterpret_cast<const uint4*>(
                  up + ((long long)kb * four_h + q * hid + k) * VEC));
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float hv = a_s[kb * VEC + v];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[q] = fmaf(hv, to_f32(uv[q][v]), acc[q]);
        }
      }
      const float gi = sigmoid_f32(acc[0] + to_f32(bias[k]));
      const float gj = tanhf(acc[1] + to_f32(bias[hid + k]));
      const float gfo =
          sigmoid_f32(acc[2] + to_f32(bias[2 * hid + k]) + forget_bias);
      const float go = sigmoid_f32(acc[3] + to_f32(bias[3 * hid + k]));
      const float c_new = gfo * c_s[k] + gi * gj;
      const float h_new = go * tanhf(c_new);
      if (live) {
        h_s[k] = h_new;
        c_s[k] = c_new;
      }
      out[row * hid + k] = from_f32<T>(live ? h_new : 0.0f);
      if (save) {
        T* g_row = g_out + row * four_h;
        g_row[k] = from_f32<T>(gi);
        g_row[hid + k] = from_f32<T>(gj);
        g_row[2 * hid + k] = from_f32<T>(gfo);
        g_row[3 * hid + k] = from_f32<T>(go);
        h_out[row * hid + k] = from_f32<T>(h_s[k]);
        c_out[row * hid + k] = from_f32<T>(c_s[k]);
      }
    }
    __syncthreads();                             // all reads of a_s done
    for (int k = threadIdx.x; k < hid; k += blockDim.x)
      a_s[k] = to_f32(from_f32<T>(h_s[k]));
    __syncthreads();
  }
}

// One direction's backward walk over batch row n, run by the whole block.
// dout, c_res: [T, N, H]; gates, dx (output): [T, N, 4H]; ut: U^T packed
// [4H/VEC][H][VEC]; db_row (output): this row's [4H] f32 sum of dg over
// time. `bw` is the BiLSTM's backward direction: t ascending, the carry from
// row t+1 (else t descending, the carry from row t-1).
template <typename T>
__device__ __forceinline__ void bwd_row(
    const T* __restrict__ dout, const T* __restrict__ gates,
    const T* __restrict__ c_res, const T* __restrict__ ut, int len,
    T* __restrict__ dx, float* __restrict__ db_row, int t_len, int n_rows,
    int n, int hid, bool bw) {
  using lstm_common::from_f32;
  using lstm_common::to_f32;
  constexpr int VEC = 16 / sizeof(T);
  const int four_h = 4 * hid;
  extern __shared__ float wide_smem[];
  float* dh_s = wide_smem;         // [H]
  float* dc_s = dh_s + hid;        // [H]
  float* dg_s = dc_s + hid;        // [4H], the rounded dg row
  for (int k = threadIdx.x; k < hid; k += blockDim.x) {
    dh_s[k] = 0.0f;
    dc_s[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) db_row[q * hid + k] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = bw ? s : t_len - 1 - s;
    const long long row = (long long)t * n_rows + n;
    T* dx_row = dx + row * four_h;
    if (t >= len) {                              // dead step, block-uniform
      for (int k = threadIdx.x; k < hid; k += blockDim.x) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dx_row[q * hid + k] = from_f32<T>(0.0f);
      }
      continue;
    }
    const int tp = bw ? t + 1 : t - 1;           // the step's incoming carry
    const bool has_prev = tp >= 0 && tp < t_len;
    const T* g_row = gates + row * four_h;
    for (int k = threadIdx.x; k < hid; k += blockDim.x) {
      const float gi = to_f32(g_row[k]);
      const float gj = to_f32(g_row[hid + k]);
      const float gfo = to_f32(g_row[2 * hid + k]);
      const float go = to_f32(g_row[3 * hid + k]);
      const float c_prev =
          has_prev ? to_f32(c_res[((long long)tp * n_rows + n) * hid + k])
                   : 0.0f;
      const float tanh_c = tanhf(gfo * c_prev + gi * gj);
      const float g_hnew = dh_s[k] + to_f32(dout[row * hid + k]);
      const float do_ = g_hnew * tanh_c;
      const float dc_tot = dc_s[k] + g_hnew * go * (1.0f - tanh_c * tanh_c);
      float dg[4];
      dg[0] = dc_tot * gj * gi * (1.0f - gi);
      dg[1] = dc_tot * gi * (1.0f - gj * gj);
      dg[2] = dc_tot * c_prev * gfo * (1.0f - gfo);
      dg[3] = do_ * go * (1.0f - go);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        db_row[q * hid + k] += dg[q];
        const T r = from_f32<T>(dg[q]);
        dx_row[q * hid + k] = r;
        dg_s[q * hid + k] = to_f32(r);
      }
      dc_s[k] = dc_tot * gfo;
    }
    __syncthreads();

    // dh[k] = sum_m dg_s[m] U[k][m], U^T packed [4H/VEC][H][VEC]
    for (int k = threadIdx.x; k < hid; k += blockDim.x) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int mb = 0; mb < four_h / VEC; ++mb) {
        alignas(16) T uv[VEC];
        *reinterpret_cast<uint4*>(uv) = __ldg(reinterpret_cast<const uint4*>(
            ut + ((long long)mb * hid + k) * VEC));
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v & 3] = fmaf(dg_s[mb * VEC + v], to_f32(uv[v]), acc[v & 3]);
      }
      dh_s[k] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();                             // dg_s is free again
  }
}

}  // namespace lstm_wide
