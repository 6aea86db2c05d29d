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
// each a [rows, 4H] x [4H, H] product per direction against a U (512 KB in
// bf16 at H = 256) larger than a block's 227 KB of shared memory; then one
// [H, T*N] x [T*N, 4H] product per direction for dU. The card's bound is
// far below the chain (0.006 ms at T = 23, N = 64): what costs time is how
// often U crosses from L2 and how long one step's dependent chain is.
//
// The TPU kernel accumulated dU and db in VMEM scratch across a sequential
// grid. GPU blocks run in parallel and in no order, so the work is three
// kernels launched by the one entry point, all deterministic (fixed
// summation order, no atomics). Dispatch by type is explicit:
//
// bf16 (the training type) up to H = 512 -- U on chip, rows in one
// tensor-core product:
//  1. bilstm_bwd_cluster_kernel, the cluster recurrence of
//     lstm_bwd_cluster.cuh that kernel 6 (lstm_bwd.cu) runs too, for both
//     directions along the grid's z: one non-portable thread-block cluster
//     of CS = 16 blocks of UB = 16 units (256 threads) per 16 batch rows
//     and direction, each block's 4 UB columns of its direction's U (32 KB)
//     in shared memory for the whole sequence, copied by the kernel
//     straight from U, each step's partial product dg U_b^T on tensor cores
//     (mma.sync), the partials summed by their owners through distributed
//     shared memory after one cluster barrier. The backward direction walks
//     t ascending with its carry from row t+1. A block takes 72,960 bytes
//     of shared memory, so three share an SM and batch 64 -- 4 row groups x
//     2 directions = 8 clusters, 128 blocks -- runs in one wave. The launch
//     checks cudaOccupancyMaxActiveClusters and fails where no cluster of
//     the shape fits (the wrapper raises); it never degrades to another
//     kernel. It replaced, for bf16, the one-block-per-row recurrence below,
//     which re-read U^T from L2 in each of 128 blocks every step and ran
//     the product as FP32 FMAs.
//  2. bilstm_bwd_du_mma_kernel, dU of one direction per blockIdx.z on
//     tensor cores (lstm_common::du_mma_tile, 64x64 output tiles, rows
//     ascending). h_prev is the saved h shifted by one time step, so it is
//     the same buffer against dx at an offset of N rows, and the first
//     (fw) or last (bw) time step, whose carry is zero, drops out.
//  3. bilstm_bwd_db_kernel, db = sum over n of db_part, per direction.
//
// f32 (the type of the tests and the gradient checks) at every H, and bf16
// past H = 512 -- the wide recurrence of lstm_wide.cuh, one block per
// (batch row, direction), U^T packed [4H/VEC][H][VEC] by the wrapper and
// streamed from L2 every step, then the dU and db launches: one entry
// point, three kernels.
//  1. bilstm_bwd_wide_kernel: each thread walks its units (one a unit up
//     to 1024 threads); a unit's gate derivatives, dc and dh are the
//     thread's. The rounded dg row (4H values) goes through shared memory,
//     and dh_prev[k] is its dot product with row k of U; four accumulators
//     break the FMA chain. A dead step (uniform over the block) writes
//     zeros and skips the product. Each block sums its row's dg over time
//     into db_part[dir][n][4H].
//  2. dU: bilstm_bwd_du_mma_kernel in bf16, bilstm_bwd_du_kernel (the FP32
//     tiled product lstm_common::du_tile) in f32.
//  3. bilstm_bwd_db_kernel as above.
// Right, not fast: every block reads all of U every step. It took the
// place of the first f32 recurrence, the same design with one thread a
// unit and H <= 256.
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

// Direction blockIdx.z: 0 forward (t descending), 1 backward (ascending).
__global__ void __launch_bounds__(lstm_bwd_cluster::kMaxThreads)
bilstm_bwd_cluster_kernel(
    const __nv_bfloat16* __restrict__ dof,
    const __nv_bfloat16* __restrict__ dob,
    const __nv_bfloat16* __restrict__ gf, const __nv_bfloat16* __restrict__ gb,
    const __nv_bfloat16* __restrict__ cf, const __nv_bfloat16* __restrict__ cb,
    const __nv_bfloat16* __restrict__ uf, const __nv_bfloat16* __restrict__ ub,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ dxf,
    __nv_bfloat16* __restrict__ dxb, float* __restrict__ db_part, int t_len,
    int n_rows, int hid, int units) {
  const bool bw = blockIdx.z == 1;
  lstm_bwd_cluster::recurrence(
      bw ? dob : dof, bw ? gb : gf, bw ? cb : cf, bw ? ub : uf, lens,
      bw ? dxb : dxf, db_part + (bw ? (long long)n_rows * 4 * hid : 0),
      t_len, n_rows, hid, units, bw);
}

// dU of one direction per blockIdx.z: du = h_prev^T dx over the rows (t, n).
__global__ void __launch_bounds__(lstm_common::kDuThreads)
bilstm_bwd_du_mma_kernel(const __nv_bfloat16* __restrict__ hf,
                         const __nv_bfloat16* __restrict__ hb,
                         const __nv_bfloat16* __restrict__ dxf,
                         const __nv_bfloat16* __restrict__ dxb,
                         float* __restrict__ duf, float* __restrict__ dub,
                         int t_len, int n_rows, int hid) {
  const int dir = blockIdx.z;
  const int four_h = 4 * hid;
  // fw: h_prev[t] = h[t-1], rows t >= 1; bw: h_prev[t] = h[t+1], rows t < T-1
  lstm_common::du_mma_tile(
      dir ? hb + (long long)n_rows * hid : hf,
      dir ? dxb : dxf + (long long)n_rows * four_h, dir ? dub : duf,
      (long long)(t_len - 1) * n_rows, hid, four_h, blockIdx.y * kTile,
      blockIdx.x * kTile);
}

// dU of one direction per blockIdx.z: du = h_prev^T dx over the rows (t, n).
__global__ void __launch_bounds__(256)
bilstm_bwd_du_kernel(const float* __restrict__ hf,
                     const float* __restrict__ hb,
                     const float* __restrict__ dxf,
                     const float* __restrict__ dxb, float* __restrict__ duf,
                     float* __restrict__ dub, int t_len, int n_rows,
                     int hid) {
  const int dir = blockIdx.z;
  const int four_h = 4 * hid;
  // fw: h_prev[t] = h[t-1], rows t >= 1; bw: h_prev[t] = h[t+1], rows t < T-1
  lstm_common::du_tile<float>(
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

// The dU grid (64x64 tiles, both directions) and the db launch, shared by
// the two types.
dim3 du_grid(int hid) {
  return dim3((4 * hid + kTile - 1) / kTile, (hid + kTile - 1) / kTile, 2);
}

int launch_db(const void* db_part, void* dbf, void* dbb, int n_rows, int hid,
              cudaStream_t stream) {
  const int four_h = 4 * hid;
  bilstm_bwd_db_kernel<<<dim3((four_h + 255) / 256, 2), 256, 0, stream>>>(
      static_cast<const float*>(db_part), static_cast<float*>(dbf),
      static_cast<float*>(dbb), n_rows, four_h);
  return (int)cudaGetLastError();
}

// --- f32, and bf16 past the cluster: lstm_wide.cuh -----------------------

// Batch row blockIdx.x, direction blockIdx.y (0 forward, 1 backward).
template <typename T>
__global__ void __launch_bounds__(lstm_wide::kMaxThreads)
bilstm_bwd_wide_kernel(const T* __restrict__ dof, const T* __restrict__ dob,
                       const T* __restrict__ gf, const T* __restrict__ gb,
                       const T* __restrict__ cf, const T* __restrict__ cb,
                       const T* __restrict__ utf, const T* __restrict__ utb,
                       const int* __restrict__ lens, T* __restrict__ dxf,
                       T* __restrict__ dxb, float* __restrict__ db_part,
                       int t_len, int n_rows, int hid) {
  const int n = blockIdx.x;
  const int dir = blockIdx.y;
  lstm_wide::bwd_row<T>(
      dir ? dob : dof, dir ? gb : gf, dir ? cb : cf, dir ? utb : utf, lens[n],
      dir ? dxb : dxf, db_part + ((long long)dir * n_rows + n) * 4 * hid,
      t_len, n_rows, n, hid, dir == 1);
}

}  // namespace

// Dynamic shared memory of one bf16 cluster block at (H, units), in bytes
// (for reports).
extern "C" int bilstm_bwd_cluster_smem(int hid, int units) {
  return (int)lstm_bwd_cluster::smem_bytes(hid, units);
}

// How many clusters of the bf16 recurrence at (H, units) the card holds at
// once (cudaOccupancyMaxActiveClusters; for reports), or -cudaError_t.
extern "C" int bilstm_bwd_max_clusters(int hid, int units) {
  if (!lstm_bwd_cluster::shape_ok(hid, units))
    return -(int)cudaErrorInvalidValue;
  return lstm_bwd_cluster::max_active_clusters(bilstm_bwd_cluster_kernel,
                                               hid, units);
}

// dof/dob, hf/hb, cf/cb: [T, N, H]; gf/gb, dxf/dxb (outputs): [T, N, 4H];
// uf/ub: U [H, 4H] as it is; lens: [N] int32; duf/dub (outputs): [H, 4H]
// f32; dbf/dbb (outputs): [4H] f32; db_part: scratch [2, N, 4H] f32; units:
// hidden units a cluster block owns (a multiple of 8, ceil(H / units) <=
// 16). H a multiple of 8, <= 512. Returns a cudaError_t
// (cudaErrorInvalidConfiguration when no cluster of ceil(H / units) blocks
// fits on the card).
extern "C" int bilstm_bwd_bf16(const void* dof, const void* dob,
                               const void* gf, const void* gb, const void* hf,
                               const void* hb, const void* cf, const void* cb,
                               const void* uf, const void* ub,
                               const void* lens, void* dxf, void* dxb,
                               void* duf, void* dub, void* dbf, void* dbb,
                               void* db_part, int t_len, int n_rows, int hid,
                               int units, void* stream_ptr) {
  using bf16 = __nv_bfloat16;
  if (t_len <= 0 || n_rows <= 0 || hid > kMaxClusterHidden)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  static int checked[2] = {-1, -1};
  int err = lstm_bwd_cluster::launch(
      bilstm_bwd_cluster_kernel, checked, hid, units, n_rows, 2, stream,
      static_cast<const bf16*>(dof), static_cast<const bf16*>(dob),
      static_cast<const bf16*>(gf), static_cast<const bf16*>(gb),
      static_cast<const bf16*>(cf), static_cast<const bf16*>(cb),
      static_cast<const bf16*>(uf), static_cast<const bf16*>(ub),
      static_cast<const int*>(lens), static_cast<bf16*>(dxf),
      static_cast<bf16*>(dxb), static_cast<float*>(db_part), t_len, n_rows,
      hid, units);
  if (err != cudaSuccess) return err;
  bilstm_bwd_du_mma_kernel<<<du_grid(hid), lstm_common::kDuThreads, 0,
                             stream>>>(
      static_cast<const bf16*>(hf), static_cast<const bf16*>(hb),
      static_cast<const bf16*>(dxf), static_cast<const bf16*>(dxb),
      static_cast<float*>(duf), static_cast<float*>(dub), t_len, n_rows, hid);
  err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_db(db_part, dbf, dbb, n_rows, hid, stream);
}

// The wide recurrence (lstm_wide.cuh): f32 at every H, bf16 past the
// cluster's 512. Arguments as bilstm_bwd_bf16 without units, with utf/utb:
// U^T packed as [4H/VEC][H][VEC] (VEC = 8 in bf16, 4 in f32); H a multiple
// of VEC, <= 8192. dU then runs on tensor cores in bf16 and as FP32 FMAs in
// f32. Returns a cudaError_t.
template <typename T>
int launch_wide(const void* dof, const void* dob, const void* gf,
                const void* gb, const void* hf, const void* hb, const void* cf,
                const void* cb, const void* utf, const void* utb,
                const void* lens, void* dxf, void* dxb, void* duf, void* dub,
                void* dbf, void* dbb, void* db_part, int t_len, int n_rows,
                int hid, void* stream_ptr) {
  if (t_len <= 0 || n_rows <= 0 || !lstm_wide::shape_ok<T>(hid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = lstm_wide::bwd_smem(hid);
  cudaError_t err = lstm_wide::allow_smem(bilstm_bwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  bilstm_bwd_wide_kernel<T><<<dim3(n_rows, 2), lstm_wide::threads(hid), smem,
                              stream>>>(
      static_cast<const T*>(dof), static_cast<const T*>(dob),
      static_cast<const T*>(gf), static_cast<const T*>(gb),
      static_cast<const T*>(cf), static_cast<const T*>(cb),
      static_cast<const T*>(utf), static_cast<const T*>(utb),
      static_cast<const int*>(lens), static_cast<T*>(dxf),
      static_cast<T*>(dxb), static_cast<float*>(db_part), t_len, n_rows, hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (sizeof(T) == 2)
    bilstm_bwd_du_mma_kernel<<<du_grid(hid), lstm_common::kDuThreads, 0,
                               stream>>>(
        static_cast<const T*>(hf), static_cast<const T*>(hb),
        static_cast<const T*>(dxf), static_cast<const T*>(dxb),
        static_cast<float*>(duf), static_cast<float*>(dub), t_len, n_rows,
        hid);
  else
    bilstm_bwd_du_kernel<<<du_grid(hid), 256, 0, stream>>>(
        static_cast<const T*>(hf), static_cast<const T*>(hb),
        static_cast<const T*>(dxf), static_cast<const T*>(dxb),
        static_cast<float*>(duf), static_cast<float*>(dub), t_len, n_rows,
        hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_db(db_part, dbf, dbb, n_rows, hid, stream);
}

extern "C" int bilstm_bwd_wide_bf16(const void* dof, const void* dob,
                                    const void* gf, const void* gb,
                                    const void* hf, const void* hb,
                                    const void* cf, const void* cb,
                                    const void* utf, const void* utb,
                                    const void* lens, void* dxf, void* dxb,
                                    void* duf, void* dub, void* dbf, void* dbb,
                                    void* db_part, int t_len, int n_rows,
                                    int hid, void* stream_ptr) {
  return launch_wide<__nv_bfloat16>(dof, dob, gf, gb, hf, hb, cf, cb, utf,
                                    utb, lens, dxf, dxb, duf, dub, dbf, dbb,
                                    db_part, t_len, n_rows, hid, stream_ptr);
}

extern "C" int bilstm_bwd_wide_f32(const void* dof, const void* dob,
                                   const void* gf, const void* gb,
                                   const void* hf, const void* hb,
                                   const void* cf, const void* cb,
                                   const void* utf, const void* utb,
                                   const void* lens, void* dxf, void* dxb,
                                   void* duf, void* dub, void* dbf, void* dbb,
                                   void* db_part, int t_len, int n_rows,
                                   int hid, void* stream_ptr) {
  return launch_wide<float>(dof, dob, gf, gb, hf, hb, cf, cb, utf, utb, lens,
                            dxf, dxb, duf, dub, dbf, dbb, db_part, t_len,
                            n_rows, hid, stream_ptr);
}
