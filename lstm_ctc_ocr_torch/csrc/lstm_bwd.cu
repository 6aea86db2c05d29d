// Backward of the masked unidirectional LSTM for Hopper (sm_90a).
//
// Replaces the TPU kernel lstm_ctc_ocr_tpu/ops/rnn_pallas.py:_bwd_kernel
// (called through _bwd_call). It reads what lstm_fwd writes with residuals
// on: post-activation gates (i, j, f, o) and the masked h and c carries,
// plus the output cotangent.
//
// Walking time descending, with h_prev/c_prev the carry step t started from
// (row t-1, zero at t = 0) and live = len > t:
//   tanh_c = tanh(f c_prev + i j)             (recomputed from saved gates)
//   g_h = live (dh + dout[t]),  g_c = live dc
//   dc_tot = g_c + g_h o (1 - tanh_c^2)
//   dg = [dc_tot j i(1-i), dc_tot i (1-j^2), dc_tot c_prev f(1-f),
//         g_h tanh_c o(1-o)]                   -> dx[t], rounded to the type
//   dh <- round(dg) U^T + (1-live) dh,  dc <- dc_tot f + (1-live) dc
//   dU += h_prev^T round(dg),  db += sum_rows dg          (f32 accumulators)
// A dead step has dg = 0 and passes dh, dc through unchanged.
//
// What bounds it on an H100: a serial chain of T steps, each a
// [rows, 4H] x [4H, H] product against U (2 MB in bf16, 4 MB in f32 at
// H = 512, nine to eighteen times one block's 227 KB of shared memory); then
// one [H, T*N] x [T*N, 4H] product for dU (15 GFLOP at H = 512, T = 111,
// N = 64). The card's bound is far below either chain: what costs time is
// how often U crosses from L2 and how long one step's dependent chain is.
//
// The TPU kernel did each step's dg U^T as one matrix-unit product over all
// rows of a chunk and accumulated dU on the MXU; GPU blocks run in parallel
// and in no order, so the work is three kernels behind the one entry point,
// all deterministic (fixed summation order, no atomics). Dispatch by type
// is explicit:
//
// bf16 (the training type) up to H = 512 -- U on chip, rows in one
// tensor-core product:
//  1. lstm_bwd_cluster_kernel, the cluster recurrence of
//     lstm_bwd_cluster.cuh that kernel 2 (bilstm_bwd.cu) runs too: one
//     non-portable thread-block cluster of CS blocks per 16 batch rows
//     (16 blocks of UB = 32 units at H = 512), each block's 4 UB columns
//     of U (128 KB) in shared memory for the whole sequence, copied by the
//     kernel straight from U, each step's partial product dg U_b^T on
//     tensor cores (mma.sync), the partials summed by their owners through
//     distributed shared memory after one cluster barrier. Why a
//     non-portable cluster of 16 and not a cooperative launch: the exchange
//     stays in the cluster's shared memory with one hardware cluster
//     barrier a step, where a grid barrier would round-trip through L2 and
//     need every block resident; a portable cluster of 8 would need 256 KB
//     of U a block at H = 512. The launch checks
//     cudaOccupancyMaxActiveClusters > 0 and fails otherwise (the wrapper
//     raises); it never degrades. Each block also sums its rows' dg over
//     time in registers and writes db_part[n][4H].
//  2. lstm_bwd_du_mma_kernel, dU = sum over rows r = (t, n) of
//     h_prev[r]^T dx[r] on tensor cores (lstm_common::du_mma_tile, 64x64
//     output tiles, rows ascending). h_prev is the saved h shifted by one
//     time step, so it is the same buffer against dx at an offset of N
//     rows, and the first time step (zero state) drops out.
//  3. lstm_bwd_db_kernel, db = sum over n of db_part.
//
// f32 (the type of the tests and the gradient checks) at every H, and bf16
// past H = 512 -- the wide recurrence of lstm_wide.cuh, then the dU and db
// launches:
//  1. lstm_bwd_wide_kernel, one block per batch row, its threads walking the
//     units (one a unit up to 1024); the rounded dg row goes through shared
//     memory and dh_prev[k] is its dot product with row k of U, read from
//     U^T packed [4H/VEC][H][VEC] (VEC = 16 bytes) in L2 every step.
//  2. dU: lstm_bwd_du_mma_kernel in bf16, lstm_bwd_du_kernel (the FP32 tiled
//     product lstm_common::du_tile) in f32.
//  3. lstm_bwd_db_kernel as above.
// Right, not fast: every block reads all of U every step. It took the
// place of the first f32 recurrence, the same design with one thread a
// unit and H <= 512.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). The entry points launch on the given
// stream, do not synchronise, and return a cudaError_t.

#include "lstm_bwd_cluster.cuh"
#include "lstm_common.cuh"
#include "lstm_wide.cuh"

namespace {

using lstm_common::kTile;

constexpr int kMaxClusterHidden = 512;   // H of the bf16 cluster recurrence

// --- bf16: the cluster recurrence (lstm_bwd_cluster.cuh) -------------------

__global__ void __launch_bounds__(lstm_bwd_cluster::kMaxThreads)
lstm_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ dout,
                        const __nv_bfloat16* __restrict__ gates,
                        const __nv_bfloat16* __restrict__ c_res,
                        const __nv_bfloat16* __restrict__ u,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ db_part, int t_len, int n_rows,
                        int hid, int ub) {
  lstm_bwd_cluster::recurrence(dout, gates, c_res, u, lens, dx, db_part,
                               t_len, n_rows, hid, ub, false);
}

__global__ void __launch_bounds__(lstm_common::kDuThreads)
lstm_bwd_du_mma_kernel(const __nv_bfloat16* __restrict__ hs,
                       const __nv_bfloat16* __restrict__ dx,
                       float* __restrict__ du, int t_len, int n_rows,
                       int hid) {
  const int four_h = 4 * hid;
  // h_prev[t] = h[t-1]: rows t >= 1 of dx against rows t-1 of h
  lstm_common::du_mma_tile(hs, dx + (long long)n_rows * four_h, du,
                           (long long)(t_len - 1) * n_rows, hid, four_h,
                           blockIdx.y * kTile, blockIdx.x * kTile);
}

template <typename T>
__global__ void __launch_bounds__(256)
lstm_bwd_du_kernel(const T* __restrict__ hs, const T* __restrict__ dx,
                   float* __restrict__ du, int t_len, int n_rows, int hid) {
  const int four_h = 4 * hid;
  // h_prev[t] = h[t-1]: rows t >= 1 of dx against rows t-1 of h
  lstm_common::du_tile<T>(hs, dx + (long long)n_rows * four_h, du,
                          (long long)(t_len - 1) * n_rows, hid, four_h,
                          blockIdx.y * kTile, blockIdx.x * kTile);
}

__global__ void __launch_bounds__(256)
lstm_bwd_db_kernel(const float* __restrict__ db_part, float* __restrict__ db,
                   int n_rows, int four_h) {
  lstm_common::db_sum(db_part, db, n_rows, four_h);
}

// --- f32, and bf16 past the cluster: lstm_wide.cuh -----------------------

template <typename T>
__global__ void __launch_bounds__(lstm_wide::kMaxThreads)
lstm_bwd_wide_kernel(const T* __restrict__ dout, const T* __restrict__ gates,
                     const T* __restrict__ c_res, const T* __restrict__ ut,
                     const int* __restrict__ lens, T* __restrict__ dx,
                     float* __restrict__ db_part, int t_len, int n_rows,
                     int hid) {
  const int n = blockIdx.x;
  lstm_wide::bwd_row<T>(dout, gates, c_res, ut, lens[n], dx,
                        db_part + (long long)n * 4 * hid, t_len, n_rows, n,
                        hid, false);
}

int launch_db(const void* db_part, void* db, int n_rows, int hid,
              cudaStream_t stream) {
  const int four_h = 4 * hid;
  lstm_bwd_db_kernel<<<(four_h + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(db_part), static_cast<float*>(db), n_rows,
      four_h);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one bf16 cluster block at (H, UB), in bytes (for
// reports).
extern "C" int lstm_bwd_cluster_smem(int hid, int ub) {
  return (int)lstm_bwd_cluster::smem_bytes(hid, ub);
}

// How many clusters of the bf16 recurrence at (H, UB) the card holds at
// once (cudaOccupancyMaxActiveClusters; for reports), or -cudaError_t.
extern "C" int lstm_bwd_max_clusters(int hid, int ub) {
  if (!lstm_bwd_cluster::shape_ok(hid, ub))
    return -(int)cudaErrorInvalidValue;
  return lstm_bwd_cluster::max_active_clusters(lstm_bwd_cluster_kernel, hid,
                                               ub);
}

// dout, hs, cs: [T, N, H]; gates, dx (output): [T, N, 4H]; u: U [H, 4H] as
// it is; lens: [N] int32; du (output): [H, 4H] f32; db (output): [4H] f32;
// db_part: scratch [N, 4H] f32; ub: hidden units a cluster block owns (a
// multiple of 8, ceil(H / ub) <= 16). H a multiple of 8, <= 512. Returns a
// cudaError_t (cudaErrorInvalidConfiguration when no cluster of ceil(H /
// ub) blocks fits on the card).
extern "C" int lstm_bwd_bf16(const void* dout, const void* gates,
                             const void* hs, const void* cs, const void* u,
                             const void* lens, void* dx, void* du, void* db,
                             void* db_part, int t_len, int n_rows, int hid,
                             int ub, void* stream_ptr) {
  using bf16 = __nv_bfloat16;
  if (t_len <= 0 || n_rows <= 0 || hid > kMaxClusterHidden)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  static int checked[2] = {-1, -1};
  int err = lstm_bwd_cluster::launch(
      lstm_bwd_cluster_kernel, checked, hid, ub, n_rows, 1, stream,
      static_cast<const bf16*>(dout), static_cast<const bf16*>(gates),
      static_cast<const bf16*>(cs), static_cast<const bf16*>(u),
      static_cast<const int*>(lens), static_cast<bf16*>(dx),
      static_cast<float*>(db_part), t_len, n_rows, hid, ub);
  if (err != cudaSuccess) return err;
  const int four_h = 4 * hid;
  lstm_bwd_du_mma_kernel<<<dim3((four_h + kTile - 1) / kTile,
                                (hid + kTile - 1) / kTile),
                           lstm_common::kDuThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(hs),
      static_cast<const __nv_bfloat16*>(dx), static_cast<float*>(du), t_len,
      n_rows, hid);
  err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_db(db_part, db, n_rows, hid, stream);
}

// The wide recurrence (lstm_wide.cuh): f32 at every H, bf16 past the
// cluster's 512. Arguments as lstm_bwd_bf16 without ub, with ut: U^T packed
// as [4H/VEC][H][VEC] (VEC = 8 in bf16, 4 in f32); H a multiple of VEC,
// <= 8192. dU then runs on tensor cores in bf16 and as FP32 FMAs in f32.
// Returns a cudaError_t.
template <typename T>
int launch_wide(const void* dout, const void* gates, const void* hs,
                const void* cs, const void* ut, const void* lens, void* dx,
                void* du, void* db, void* db_part, int t_len, int n_rows,
                int hid, void* stream_ptr) {
  if (t_len <= 0 || n_rows <= 0 || !lstm_wide::shape_ok<T>(hid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = lstm_wide::bwd_smem(hid);
  cudaError_t err = lstm_wide::allow_smem(lstm_bwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_wide_kernel<T><<<n_rows, lstm_wide::threads(hid), smem, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(gates),
      static_cast<const T*>(cs), static_cast<const T*>(ut),
      static_cast<const int*>(lens), static_cast<T*>(dx),
      static_cast<float*>(db_part), t_len, n_rows, hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int four_h = 4 * hid;
  const dim3 grid((four_h + kTile - 1) / kTile, (hid + kTile - 1) / kTile);
  if constexpr (sizeof(T) == 2)
    lstm_bwd_du_mma_kernel<<<grid, lstm_common::kDuThreads, 0, stream>>>(
        static_cast<const T*>(hs), static_cast<const T*>(dx),
        static_cast<float*>(du), t_len, n_rows, hid);
  else
    lstm_bwd_du_kernel<T><<<grid, 256, 0, stream>>>(
        static_cast<const T*>(hs), static_cast<const T*>(dx),
        static_cast<float*>(du), t_len, n_rows, hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_db(db_part, db, n_rows, hid, stream);
}

extern "C" int lstm_bwd_wide_bf16(const void* dout, const void* gates,
                                  const void* hs, const void* cs,
                                  const void* ut, const void* lens, void* dx,
                                  void* du, void* db, void* db_part,
                                  int t_len, int n_rows, int hid,
                                  void* stream_ptr) {
  return launch_wide<__nv_bfloat16>(dout, gates, hs, cs, ut, lens, dx, du, db,
                                    db_part, t_len, n_rows, hid, stream_ptr);
}

extern "C" int lstm_bwd_wide_f32(const void* dout, const void* gates,
                                 const void* hs, const void* cs,
                                 const void* ut, const void* lens, void* dx,
                                 void* du, void* db, void* db_part, int t_len,
                                 int n_rows, int hid, void* stream_ptr) {
  return launch_wide<float>(dout, gates, hs, cs, ut, lens, dx, du, db,
                            db_part, t_len, n_rows, hid, stream_ptr);
}
