// Backward of the fused masked bidirectional LSTM for Hopper (sm_90a).
//
// Replaces the TPU kernel lstm_ctc_ocr_tpu/ops/rnn_pallas.py:_bi_bwd_kernel
// (called through _bi_bwd_call; one step is _bi_bwd_step). It reads what
// bilstm_fwd writes with residuals on: post-activation gates (i, j, f, o)
// and the masked h and c carries, per direction, plus the output cotangents.
//
// Per direction, walking the forward's scan order backwards (fw: physical
// time descending, bw: ascending), with h_prev/c_prev the carry the forward
// step started from (fw: row t-1, zero at t = 0; bw: row t+1, zero at
// t = T-1) and live = len > t:
//   tanh_c = tanh(f c_prev + i j)             (recomputed from saved gates)
//   g_h = live (dh + dout[t]),  g_c = live dc
//   dc_tot = g_c + g_h o (1 - tanh_c^2)
//   dg = [dc_tot j i(1-i), dc_tot i (1-j^2), dc_tot c_prev f(1-f),
//         g_h tanh_c o(1-o)]                   -> dx[t], rounded to the type
//   dh <- round(dg) U^T + (1-live) dh,  dc <- dc_tot f + (1-live) dc
//   dU += h_prev^T round(dg),  db += sum_rows dg          (f32 accumulators)
// A dead step has dg = 0 and passes dh, dc through unchanged.
//
// What bounds it on an H100: like the forward, a serial chain of T steps,
// each a [rows, 4H] x [4H, H] product against a U^T (512 KB in bf16) that
// does not fit a block's shared memory and is re-read from L2 every step,
// with FP32 FMAs on CUDA cores; then one [H, T*N] x [T*N, 4H] product per
// direction for dU.
//
// Design: the TPU kernel accumulated dU and db in VMEM scratch across a
// sequential grid. GPU blocks run in parallel and in no order, so the work
// is three kernels launched by the one entry point, all deterministic (no
// atomics):
//  1. bilstm_bwd_rec_kernel, the recurrence. One block per (batch row,
//     direction), H threads; thread k owns hidden unit k: the gate
//     derivatives, dc and dh of that unit are thread-local. The rounded dg
//     row (4H values) goes through shared memory, and dh_prev[k] is its dot
//     product with row k of U. The wrapper hands U^T packed as
//     [4H/VEC][H][VEC] (VEC = 16 bytes of the element type), so a thread's
//     16-byte load brings VEC consecutive entries of its row and a warp's
//     loads cover 512 contiguous bytes; four accumulators break the FMA
//     chain. A dead step (uniform over the block) writes zeros and skips the
//     product. Each block sums its row's dg over time in registers and
//     writes it to db_part[dir][n][4H].
//  2. bilstm_bwd_du_kernel, dU = sum over rows r = (t, n) of
//     h_prev[r]^T dx[r]: a shared-memory tiled product (du_tile in
//     lstm_common.cuh, shared with lstm_bwd.cu), 64x64 output tile per
//     block, 4x4 per thread, 16 rows per tile step, f32 accumulators.
//     h_prev is the saved h shifted by one time step, so it is the same
//     buffer at an offset of N rows and the first (last) time step drops out.
//  3. bilstm_bwd_db_kernel, db = sum over n of db_part.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). The entry points launch on the given
// stream, do not synchronise, and return cudaGetLastError().

#include "lstm_common.cuh"

namespace {

using lstm_common::from_f32;
using lstm_common::kTile;
using lstm_common::to_f32;

constexpr int kMaxHidden = 256;   // H: threads per recurrence block

template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
bilstm_bwd_rec_kernel(const T* __restrict__ dof, const T* __restrict__ dob,
                      const T* __restrict__ gf, const T* __restrict__ gb,
                      const T* __restrict__ cf, const T* __restrict__ cb,
                      const T* __restrict__ utf, const T* __restrict__ utb,
                      const int* __restrict__ lens,
                      T* __restrict__ dxf, T* __restrict__ dxb,
                      float* __restrict__ db_part,
                      int t_len, int n_rows, int hid) {
  constexpr int VEC = 16 / sizeof(T);
  const int dir = blockIdx.y;                    // 0: forward, 1: backward
  const T* __restrict__ dout = dir ? dob : dof;
  const T* __restrict__ gates = dir ? gb : gf;
  const T* __restrict__ c_res = dir ? cb : cf;
  const T* __restrict__ ut = dir ? utb : utf;
  T* __restrict__ dx = dir ? dxb : dxf;

  const int k = threadIdx.x;                     // hidden unit
  const int n = blockIdx.x;                      // batch row
  const int four_h = 4 * hid;
  const int len = lens[n];

  extern __shared__ float dg_row[];              // [4H], rounded dg

  float dh = 0.0f, dc = 0.0f;
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int s = 0; s < t_len; ++s) {
    const int t = dir ? s : t_len - 1 - s;       // reverse scan order
    const long long row = (long long)t * n_rows + n;
    T* dx_row = dx + row * four_h;
    if (len <= t) {                              // dead step, block-uniform
      const T zero = from_f32<T>(0.0f);
#pragma unroll
      for (int q = 0; q < 4; ++q) dx_row[q * hid + k] = zero;
      continue;
    }
    const T* g_row = gates + row * four_h;
    const float gi = to_f32(g_row[k]);
    const float gj = to_f32(g_row[hid + k]);
    const float gfo = to_f32(g_row[2 * hid + k]);
    const float go = to_f32(g_row[3 * hid + k]);
    const int tp = dir ? t + 1 : t - 1;          // the step's incoming carry
    const bool has_prev = dir ? (t < t_len - 1) : (t > 0);
    const float c_prev =
        has_prev ? to_f32(c_res[((long long)tp * n_rows + n) * hid + k]) : 0.0f;

    const float tanh_c = tanhf(gfo * c_prev + gi * gj);
    const float g_hnew = dh + to_f32(dout[row * hid + k]);
    const float do_ = g_hnew * tanh_c;
    const float dc_tot = dc + g_hnew * go * (1.0f - tanh_c * tanh_c);
    float dg[4];
    dg[0] = dc_tot * gj * gi * (1.0f - gi);
    dg[1] = dc_tot * gi * (1.0f - gj * gj);
    dg[2] = dc_tot * c_prev * gfo * (1.0f - gfo);
    dg[3] = do_ * go * (1.0f - go);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      db_acc[q] += dg[q];
      const T r = from_f32<T>(dg[q]);
      dx_row[q * hid + k] = r;
      dg_row[q * hid + k] = to_f32(r);
    }
    dc = dc_tot * gfo;
    __syncthreads();

    // dh[k] = sum_m dg_row[m] * U[k][m], U^T packed [4H/VEC][H][VEC]
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int mb = 0; mb < four_h / VEC; ++mb) {
      alignas(16) T uv[VEC];
      *reinterpret_cast<uint4*>(uv) = __ldg(reinterpret_cast<const uint4*>(
          ut + ((long long)mb * hid + k) * VEC));
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v & 3] = fmaf(dg_row[mb * VEC + v], to_f32(uv[v]), acc[v & 3]);
    }
    dh = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();                             // dg_row is free again
  }

  float* part = db_part + ((long long)dir * n_rows + n) * four_h;
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q * hid + k] = db_acc[q];
}

// dU of one direction per blockIdx.z: du = h_prev^T dx over the rows (t, n).
template <typename T>
__global__ void __launch_bounds__(256)
bilstm_bwd_du_kernel(const T* __restrict__ hf, const T* __restrict__ hb,
                     const T* __restrict__ dxf, const T* __restrict__ dxb,
                     float* __restrict__ duf, float* __restrict__ dub,
                     int t_len, int n_rows, int hid) {
  const int dir = blockIdx.z;
  const int four_h = 4 * hid;
  // fw: h_prev[t] = h[t-1], rows t >= 1; bw: h_prev[t] = h[t+1], rows t < T-1
  lstm_common::du_tile<T>(
      dir ? hb + (long long)n_rows * hid : hf,
      dir ? dxb : dxf + (long long)n_rows * four_h, dir ? dub : duf,
      (long long)(t_len - 1) * n_rows, hid, four_h, blockIdx.y * kTile,
      blockIdx.x * kTile);
}

__global__ void __launch_bounds__(256)
bilstm_bwd_db_kernel(const float* __restrict__ db_part,
                     float* __restrict__ dbf, float* __restrict__ dbb,
                     int n_rows, int four_h) {
  const int dir = blockIdx.y;
  lstm_common::db_sum(db_part + (long long)dir * n_rows * four_h,
                      dir ? dbb : dbf, n_rows, four_h);
}

template <typename T>
int launch(const void* dof, const void* dob, const void* gf, const void* gb,
           const void* hf, const void* hb, const void* cf, const void* cb,
           const void* utf, const void* utb, const void* lens, void* dxf,
           void* dxb, void* duf, void* dub, void* dbf, void* dbb,
           void* db_part, int t_len, int n_rows, int hid, void* stream_ptr) {
  constexpr int VEC = 16 / sizeof(T);
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden ||
      hid % VEC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int four_h = 4 * hid;
  bilstm_bwd_rec_kernel<T>
      <<<dim3(n_rows, 2), hid, sizeof(float) * four_h, stream>>>(
          static_cast<const T*>(dof), static_cast<const T*>(dob),
          static_cast<const T*>(gf), static_cast<const T*>(gb),
          static_cast<const T*>(cf), static_cast<const T*>(cb),
          static_cast<const T*>(utf), static_cast<const T*>(utb),
          static_cast<const int*>(lens), static_cast<T*>(dxf),
          static_cast<T*>(dxb), static_cast<float*>(db_part), t_len, n_rows,
          hid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bilstm_bwd_du_kernel<T>
      <<<dim3((four_h + kTile - 1) / kTile, (hid + kTile - 1) / kTile, 2), 256,
         0, stream>>>(
          static_cast<const T*>(hf), static_cast<const T*>(hb),
          static_cast<const T*>(dxf), static_cast<const T*>(dxb),
          static_cast<float*>(duf), static_cast<float*>(dub), t_len, n_rows,
          hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bilstm_bwd_db_kernel<<<dim3((four_h + 255) / 256, 2), 256, 0, stream>>>(
      static_cast<const float*>(db_part), static_cast<float*>(dbf),
      static_cast<float*>(dbb), n_rows, four_h);
  return (int)cudaGetLastError();
}

}  // namespace

// dof/dob, hf/hb, cf/cb: [T, N, H]; gf/gb, dxf/dxb (outputs): [T, N, 4H];
// utf/utb: U^T packed as [4H/VEC][H][VEC]; lens: [N] int32; duf/dub
// (outputs): [H, 4H] f32; dbf/dbb (outputs): [4H] f32; db_part: scratch
// [2, N, 4H] f32. Returns a cudaError_t.
extern "C" int bilstm_bwd_bf16(const void* dof, const void* dob,
                               const void* gf, const void* gb, const void* hf,
                               const void* hb, const void* cf, const void* cb,
                               const void* utf, const void* utb,
                               const void* lens, void* dxf, void* dxb,
                               void* duf, void* dub, void* dbf, void* dbb,
                               void* db_part, int t_len, int n_rows, int hid,
                               void* stream) {
  return launch<__nv_bfloat16>(dof, dob, gf, gb, hf, hb, cf, cb, utf, utb,
                               lens, dxf, dxb, duf, dub, dbf, dbb, db_part,
                               t_len, n_rows, hid, stream);
}

extern "C" int bilstm_bwd_f32(const void* dof, const void* dob, const void* gf,
                              const void* gb, const void* hf, const void* hb,
                              const void* cf, const void* cb, const void* utf,
                              const void* utb, const void* lens, void* dxf,
                              void* dxb, void* duf, void* dub, void* dbf,
                              void* dbb, void* db_part, int t_len, int n_rows,
                              int hid, void* stream) {
  return launch<float>(dof, dob, gf, gb, hf, hb, cf, cb, utf, utb, lens, dxf,
                       dxb, duf, dub, dbf, dbb, db_part, t_len, n_rows, hid,
                       stream);
}
