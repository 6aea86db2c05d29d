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
// bf16 (the training type) -- U on chip, rows in one tensor-core product:
//  1. lstm_bwd_cluster_kernel, the recurrence. The batch rows go in groups
//     of 16 (the mma M); each group is one thread-block cluster of CS
//     blocks, and block b of it owns the UB hidden units [b UB, (b+1) UB)
//     (UB = 8 ceil(H / 128), the mma N of 8 at least; CS = ceil(H / UB) <=
//     16: at H = 512, 16 blocks of 32 units; at H = 256, 16 of 16; at H = 8,
//     one of 8). Block b loads its 4 UB columns of U -- U[:, q H + b UB + j]
//     for the gates q, all H rows, packed by the wrapper as [CS][H][4 UB]:
//     128 KB at H = 512 -- into shared memory once with cp.async and keeps
//     them for the whole sequence, so U crosses L2 once per cluster and
//     launch, not once per block and step. Thread (row r, unit j) computes
//     its four dg values (thread-local as in the f32 kernel), writes dx and
//     puts the rounded dg into the block's A tile [16][4 UB]. Each step the
//     block then computes the PARTIAL product P_b = dg[:, its columns]
//     U[:, its columns]^T, [16, H] in f32, with mma.sync m16n8k16 (each warp
//     owns four n8 tiles of the H outputs, the depth 4 UB in k16 steps) and
//     stores it, double-buffered by t's parity. One cluster barrier; then
//     thread (r, j) of block b reads P_b'[r][b UB + j] from each block b' of
//     the cluster through distributed shared memory and adds them in
//     ascending b': that sum is dh[r, b UB + j]. A dead row has dg = 0 in
//     every block, so its sum is 0 and dh, dc pass through (the TPU
//     kernel's form, rnn_pallas.py:225-244).
//     Why partial products and not the dg slices: each block then reads
//     16 x UB f32 from each of CS blocks (32 KB a step at H = 512) instead
//     of the whole dg row block (64 KB), and each warp's product needs no
//     reduction across warps. Why a non-portable cluster of 16 and not a
//     cooperative launch: the exchange stays in the cluster's shared
//     memory with one hardware cluster barrier a step, where a grid barrier
//     would round-trip through L2 and need every block resident; a
//     portable cluster of 8 would need 256 KB of U a block at H = 512. The
//     launch checks cudaOccupancyMaxActiveClusters > 0 and fails otherwise
//     (the wrapper raises); it never degrades. Each block also sums its
//     rows' dg over time in registers and writes db_part[n][4H].
//  2. lstm_bwd_du_mma_kernel, dU = sum over rows r = (t, n) of
//     h_prev[r]^T dx[r] on tensor cores (lstm_common::du_mma_tile, 64x64
//     output tiles, rows ascending). h_prev is the saved h shifted by one
//     time step, so it is the same buffer against dx at an offset of N
//     rows, and the first time step (zero state) drops out.
//  3. lstm_bwd_db_kernel, db = sum over n of db_part.
//
// f32 -- one block per batch row (its 4 MB of U^T fits no cluster):
//  1. lstm_bwd_rec_kernel, one block per batch row, H threads; thread k owns
//     hidden unit k; the rounded dg row goes through shared memory and
//     dh_prev[k] is its dot product with row k of U, read from U^T packed
//     [4H/VEC][H][VEC] (VEC = 16 bytes) in L2 every step.
//  2. lstm_bwd_du_kernel, the FP32 tiled product lstm_common::du_tile.
//  3. lstm_bwd_db_kernel as above.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). The entry points launch on the given
// stream, do not synchronise, and return a cudaError_t.

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using lstm_common::cp_async16;
using lstm_common::from_f32;
using lstm_common::kTile;
using lstm_common::smem_addr;
using lstm_common::to_f32;

constexpr int kMaxHidden = 512;   // H: threads per f32 recurrence block
constexpr int kGroupRows = 16;    // batch rows per cluster: the mma M
constexpr int kMaxCluster = 16;   // blocks per cluster (non-portable above 8)
constexpr int kMaxUnits = 32;     // hidden units per cluster block

// --- bf16: the cluster recurrence ------------------------------------------

// Shared memory of one cluster block: U's columns [H][4 UB + 8] bf16, the
// partial products [2][16][H + 8] f32, the A tile [16][4 UB + 8] bf16 (each
// pad keeps ldmatrix or the accumulator stores free of bank conflicts).
__host__ __device__ constexpr int cluster_pitch(int ub) { return 4 * ub + 8; }
__host__ __device__ constexpr size_t cluster_smem(int hid, int ub) {
  return (size_t)hid * cluster_pitch(ub) * 2 +
         (size_t)2 * kGroupRows * (hid + 8) * 4 +
         (size_t)kGroupRows * cluster_pitch(ub) * 2;
}

__global__ void __launch_bounds__(kGroupRows * kMaxUnits)
lstm_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ dout,
                        const __nv_bfloat16* __restrict__ gates,
                        const __nv_bfloat16* __restrict__ c_res,
                        const __nv_bfloat16* __restrict__ u_pack,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ db_part, int t_len, int n_rows,
                        int hid, int ub) {
  using bf16 = __nv_bfloat16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k_len = 4 * ub, ld = cluster_pitch(ub);
  const int four_h = 4 * hid;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* u_s = reinterpret_cast<bf16*>(smem);                     // [H][ld]
  const int p_ld = hid + 8;                      // partial products' pitch
  float* p_s = reinterpret_cast<float*>(smem + (size_t)hid * ld * 2);
  bf16* a_s =                                                   // [16][ld]
      reinterpret_cast<bf16*>(p_s + 2 * kGroupRows * p_ld);

  // this block's columns of U, once for the whole sequence
  {
    const bf16* src = u_pack + (size_t)rank * hid * k_len;
    const int cpr = k_len / 8;                   // 16-byte chunks per row
    for (int i = tid; i < hid * cpr; i += blockDim.x) {
      const int n = i / cpr, c = (i % cpr) * 8;
      cp_async16(smem_addr(u_s + n * ld + c), src + (size_t)n * k_len + c,
                 true);
    }
    lstm_common::cp_async_commit();
  }

  // this thread's (row, unit)
  const int r = tid / ub, j = tid % ub;
  const int k = rank * ub + j;                   // hidden unit
  const int n = blockIdx.y * kGroupRows + r;     // batch row
  const bool owns = n < n_rows && k < hid;
  const int len = owns ? lens[n] : 0;

  float dh = 0.0f, dc = 0.0f;
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // step t's inputs, loaded one step ahead
  float g_nx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c_nx = 0.0f, do_nx = 0.0f;
  auto fetch = [&](int t) {
    if (!owns || t < 0 || t >= len) return;
    const long long row = (long long)t * n_rows + n;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g_nx[q] = to_f32(gates[row * four_h + q * hid + k]);
    c_nx = t > 0 ? to_f32(c_res[((long long)(t - 1) * n_rows + n) * hid + k])
                 : 0.0f;
    do_nx = to_f32(dout[row * hid + k]);
  };
  fetch(t_len - 1);

  // the mma: warp w owns the n8 tiles 4w .. 4w+3 of the H outputs
  const int mi = lane / 8, mj = lane % 8;
  const int n_tiles = hid / 8;

  for (int t = t_len - 1; t >= 0; --t) {
    const int par = t & 1;
    const bool live = owns && t < len;
    const float gi = g_nx[0], gj = g_nx[1], gfo = g_nx[2], go = g_nx[3];
    const float c_prev = c_nx, d_out = do_nx;
    fetch(t - 1);

    float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      const float tanh_c = tanhf(gfo * c_prev + gi * gj);
      const float g_hnew = dh + d_out;
      const float do_ = g_hnew * tanh_c;
      const float dc_tot = dc + g_hnew * go * (1.0f - tanh_c * tanh_c);
      dg[0] = dc_tot * gj * gi * (1.0f - gi);
      dg[1] = dc_tot * gi * (1.0f - gj * gj);
      dg[2] = dc_tot * c_prev * gfo * (1.0f - gfo);
      dg[3] = do_ * go * (1.0f - go);
      dc = dc_tot * gfo;
    }
    bf16* dx_row = dx + ((long long)t * n_rows + n) * four_h;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      db_acc[q] += dg[q];
      const bf16 rq = from_f32<bf16>(dg[q]);
      if (owns) dx_row[q * hid + k] = rq;
      a_s[r * ld + q * ub + j] = rq;
    }
    lstm_common::cp_async_wait<0>();             // U has landed (first step)
    __syncthreads();

    // P[par] = a_s [16, 4 UB] x (this block's U columns)^T  ->  [16, H]
    float* p_out = p_s + par * kGroupRows * p_ld;
    if (warp * 4 < n_tiles) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kMaxUnits / 4; ++ks) {   // unrolled: fragment
        const int kk = ks * 16;                      // loads overlap mmas
        if (kk >= k_len) break;
        uint32_t af[4], bq[2][4];
        lstm_common::ldmatrix_x4(
            af, smem_addr(a_s + (lane % 16) * ld + kk + (lane / 16) * 8));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // rows of U past H (a partial last pair) are clamped: their
          // products are never stored
          const int row = min((warp * 4 + 2 * p) * 8 + (mi / 2) * 8 + mj,
                              hid - 1);
          lstm_common::ldmatrix_x4(
              bq[p], smem_addr(u_s + row * ld + kk + (mi % 2) * 8));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          lstm_common::mma_bf16(acc[i], af, bq[i / 2][(i % 2) * 2],
                                bq[i / 2][(i % 2) * 2 + 1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = warp * 4 + i;
        if (nt >= n_tiles) continue;
        const int col = nt * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(p_out + (lane / 4) * p_ld + col) =
            make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(p_out + (lane / 4 + 8) * p_ld + col) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
    cluster.sync();

    // dh[r, k] = sum over the cluster's blocks, ascending, of P_b'[r][k]
    if (owns) {
      float sum = 0.0f;
      for (int b = 0; b < cs; ++b) {
        const float* remote = cluster.map_shared_rank(p_out, b);
        sum += remote[r * p_ld + k];
      }
      dh = sum + (live ? 0.0f : dh);
    }
  }
  // no block leaves while another may still read its partial products
  cluster.sync();

  if (owns) {
    float* part = db_part + (long long)n * four_h;
#pragma unroll
    for (int q = 0; q < 4; ++q) part[q * hid + k] = db_acc[q];
  }
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

// --- f32: one block per batch row ------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
lstm_bwd_rec_kernel(const T* __restrict__ dout, const T* __restrict__ gates,
                    const T* __restrict__ c_res, const T* __restrict__ ut,
                    const int* __restrict__ lens, T* __restrict__ dx,
                    float* __restrict__ db_part, int t_len, int n_rows,
                    int hid) {
  constexpr int VEC = 16 / sizeof(T);
  const int k = threadIdx.x;                     // hidden unit
  const int n = blockIdx.x;                      // batch row
  const int four_h = 4 * hid;
  const int len = lens[n];

  extern __shared__ float dg_row[];              // [4H], rounded dg

  float dh = 0.0f, dc = 0.0f;
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int t = t_len - 1; t >= 0; --t) {
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
    const float c_prev =
        t > 0 ? to_f32(c_res[((long long)(t - 1) * n_rows + n) * hid + k])
              : 0.0f;

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

  float* part = db_part + (long long)n * four_h;
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q * hid + k] = db_acc[q];
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

int launch_db(const void* db_part, void* db, int n_rows, int hid,
              cudaStream_t stream) {
  const int four_h = 4 * hid;
  lstm_bwd_db_kernel<<<(four_h + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(db_part), static_cast<float*>(db), n_rows,
      four_h);
  return (int)cudaGetLastError();
}

bool cluster_shape_ok(int hid, int ub) {
  return ub > 0 && ub % 8 == 0 && ub <= kMaxUnits &&
         (hid + ub - 1) / ub <= kMaxCluster &&
         cluster_smem(hid, ub) <= 232448;    // a block's shared memory
}

// The launch configuration of the bf16 recurrence at (H, UB): clusters of
// CS blocks along x, one cluster per 16 rows along y.
void cluster_config(int hid, int ub, int n_groups, cudaStream_t stream,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int cs = (hid + ub - 1) / ub;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cs, n_groups, 1);
  cfg->blockDim = dim3(kGroupRows * ub, 1, 1);
  cfg->dynamicSmemBytes = cluster_smem(hid, ub);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Sets the recurrence's attributes for (H, UB) and returns how many of its
// clusters the card holds at once, or -cudaError_t.
int max_active_clusters(int hid, int ub) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(hid, ub, 1, nullptr, &cfg, &attr);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (err == cudaSuccess && attr.val.clusterDim.x > 8)
    err = cudaFuncSetAttribute(lstm_bwd_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, lstm_bwd_cluster_kernel,
                                         &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// The cluster launch of the bf16 recurrence; fails (never degrades) when
// the card cannot hold one cluster of this shape.
int launch_cluster(const void* dout, const void* gates, const void* cs_res,
                   const void* u_pack, const void* lens, void* dx,
                   void* db_part, int t_len, int n_rows, int hid, int ub,
                   cudaStream_t stream) {
  if (!cluster_shape_ok(hid, ub)) return (int)cudaErrorInvalidValue;
  // the attributes and the occupancy check, once per shape
  static int checked_hid = -1, checked_ub = -1;
  if (checked_hid != hid || checked_ub != ub) {
    const int clusters = max_active_clusters(hid, ub);
    if (clusters < 0) return -clusters;
    if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
    checked_hid = hid;
    checked_ub = ub;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(hid, ub, (n_rows + kGroupRows - 1) / kGroupRows, stream,
                 &cfg, &attr);
  return (int)cudaLaunchKernelEx(
      &cfg, lstm_bwd_cluster_kernel, static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(gates),
      static_cast<const __nv_bfloat16*>(cs_res),
      static_cast<const __nv_bfloat16*>(u_pack),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(db_part), t_len, n_rows, hid, ub);
}

}  // namespace

// Dynamic shared memory of one bf16 cluster block at (H, UB), in bytes (for
// reports).
extern "C" int lstm_bwd_cluster_smem(int hid, int ub) {
  return (int)cluster_smem(hid, ub);
}

// How many clusters of the bf16 recurrence at (H, UB) the card holds at
// once (cudaOccupancyMaxActiveClusters; for reports), or -cudaError_t.
extern "C" int lstm_bwd_max_clusters(int hid, int ub) {
  if (!cluster_shape_ok(hid, ub)) return -(int)cudaErrorInvalidValue;
  return max_active_clusters(hid, ub);
}

// dout, hs, cs: [T, N, H]; gates, dx (output): [T, N, 4H]; u_pack: U's
// columns packed [CS][H][4 UB] (block b's gate columns q H + b UB + j, zero
// past H; CS = ceil(H / UB)); lens: [N] int32; du (output): [H, 4H] f32; db
// (output): [4H] f32; db_part: scratch [N, 4H] f32; ub: hidden units a
// cluster block owns (a multiple of 8, CS <= 16). H a multiple of 8, <= 512.
// Returns a cudaError_t (cudaErrorInvalidConfiguration when no cluster of
// CS blocks fits on the card).
extern "C" int lstm_bwd_bf16(const void* dout, const void* gates,
                             const void* hs, const void* cs,
                             const void* u_pack, const void* lens, void* dx,
                             void* du, void* db, void* db_part, int t_len,
                             int n_rows, int hid, int ub, void* stream_ptr) {
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden ||
      hid % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = launch_cluster(dout, gates, cs, u_pack, lens, dx, db_part, t_len,
                           n_rows, hid, ub, stream);
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

// As lstm_bwd_bf16, with ut: U^T packed as [4H/4][H][4]. Returns a
// cudaError_t.
extern "C" int lstm_bwd_f32(const void* dout, const void* gates,
                            const void* hs, const void* cs, const void* ut,
                            const void* lens, void* dx, void* du, void* db,
                            void* db_part, int t_len, int n_rows, int hid,
                            void* stream_ptr) {
  using T = float;
  constexpr int VEC = 16 / sizeof(T);
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden ||
      hid % VEC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int four_h = 4 * hid;
  lstm_bwd_rec_kernel<T><<<n_rows, hid, sizeof(float) * four_h, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(gates),
      static_cast<const T*>(cs), static_cast<const T*>(ut),
      static_cast<const int*>(lens), static_cast<T*>(dx),
      static_cast<float*>(db_part), t_len, n_rows, hid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_du_kernel<T>
      <<<dim3((four_h + kTile - 1) / kTile, (hid + kTile - 1) / kTile), 256, 0,
         stream>>>(static_cast<const T*>(hs), static_cast<const T*>(dx),
                   static_cast<float*>(du), t_len, n_rows, hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_db(db_part, db, n_rows, hid, stream);
}
