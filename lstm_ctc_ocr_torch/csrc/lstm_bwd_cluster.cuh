// The bf16 recurrence shared by the two LSTM backward kernels for Hopper
// (sm_90a): lstm_bwd.cu (kernel 6, one direction) and bilstm_bwd.cu
// (kernel 2, both directions in one launch along the grid's z), each up to
// H = 512; wider H runs the wide recurrence of lstm_wide.cuh. Their f32
// paths keep their one-block-per-row kernels.
//
// The step, per direction, walking the forward's scan order backwards (the
// forward direction: t descending, with h_prev/c_prev the carry from row
// t-1, zero at t = 0; the BiLSTM's backward direction: t ascending, the
// carry from row t+1, zero at t = T-1), live = len > t:
//   tanh_c = tanh(f c_prev + i j)             (recomputed from saved gates)
//   g_h = live (dh + dout[t]),  g_c = live dc
//   dc_tot = g_c + g_h o (1 - tanh_c^2)
//   dg = [dc_tot j i(1-i), dc_tot i (1-j^2), dc_tot c_prev f(1-f),
//         g_h tanh_c o(1-o)]                   -> dx[t], rounded to bf16
//   dh <- round(dg) U^T + (1-live) dh,  dc <- dc_tot f + (1-live) dc
//   db += sum_rows dg                                  (f32 accumulators)
// A dead step has dg = 0 and passes dh, dc through unchanged. dU = sum
// h_prev^T round(dg) is left to the kernels' second launch
// (lstm_common::du_mma_tile over dx), db to the third.
//
// Geometry. The batch rows go in groups of 16 (the mma M); each group and
// direction is one thread-block cluster of CS blocks (a cluster never spans
// two directions), and block b owns the UB hidden units [b UB, (b+1) UB)
// (UB = 8 ceil(H / 128), CS = ceil(H / UB) <= 16, as in the forward
// recurrence: 16 blocks of 32 units at H = 512, 16 of 16 at H = 256, one
// of 8 at H = 8). A block has 16 UB threads; thread (r, j) owns row r of
// the group and unit b UB + j: its four dg values, dc and dh are
// thread-local, as thread k's were in the one-block-per-row kernels.
//
// U on chip. Block b copies its 4 UB gate columns of U -- U[n, q H + b UB
// + j] for the gates q and all rows n -- into shared memory once, with
// cp.async straight from U [H, 4H] (zero past H), and keeps them for the
// whole sequence. That image is rnn_cuda.pack_u_slices(U, UB)[b], [H][4 UB]
// (128 KB at H = 512, 32 KB at H = 256), gathered by the copy itself: the
// wrappers hand U as it is and pack nothing with torch ops. U crosses L2
// once per cluster and launch, not once per block and step.
//
// A step (one cluster barrier and one block barrier):
//  1. dg. Thread (r, j) computes its four dg values from the gates, the
//     carry and dout (loaded one step ahead), writes dx and puts the
//     rounded dg into the block's A tile [16][4 UB].
//  2. Partial product. The block computes P_b = dg[:, its columns]
//     U[:, its columns]^T, [16, H] in f32, with mma.sync m16n8k16: warp w
//     owns the n8 tiles 4w .. 4w+3 of the H outputs and the whole depth
//     4 UB in k16 steps (U_b is stored n-major, so it reaches the mma
//     through plain ldmatrix), and stores P_b, double-buffered by the
//     step's parity.
//  3. Exchange. One cluster barrier; then thread (r, j) of block b reads
//     P_b'[r][b UB + j] from each block b' of the cluster through
//     distributed shared memory and adds them in ascending b': that sum is
//     dh[r, b UB + j]. The order is fixed, so two calls are bit-identical.
//     A dead row has dg = 0 in every block, so its sum is 0 and dh, dc
//     pass through (the TPU kernels' form, rnn_pallas.py:225-244).
// Why partial products and not the dg slices: each block then reads 16 x
// UB f32 from each of CS blocks (32 KB a step at H = 512) instead of the
// whole dg row block (64 KB), and each warp's product needs no reduction
// across warps. Pushing the partials with remote stores measured slower
// than pulling them on an H100. The buffer a step writes
// is read by the cluster after that step's barrier; the next write to it,
// two steps on, comes after the next barrier, which no block passes before
// the whole cluster has finished its reads. One more cluster barrier after
// the time loop keeps every block resident until the last reads are done.
// Each block also sums its rows' dg over time in registers and writes
// db_part[n][4H].

#pragma once

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace lstm_bwd_cluster {

namespace cg = cooperative_groups;

constexpr int kGroupRows = 16;    // batch rows per cluster: the mma M
constexpr int kMaxCluster = 16;   // blocks per cluster (non-portable above 8)
constexpr int kMaxUnits = 32;     // hidden units per cluster block
constexpr int kMaxThreads = kGroupRows * kMaxUnits;

// Shared-memory pitches, in elements; each pad keeps ldmatrix (rows 16
// bytes apart in the bank space) or the partials' float2 stores free of
// bank conflicts.
__host__ __device__ constexpr int u_pitch(int ub) { return 4 * ub + 8; }
__host__ __device__ constexpr int p_pitch(int hid) { return hid + 8; }

// Shared memory of one cluster block: U's columns [H][4 UB + 8] bf16, the
// partial products [2][16][H + 8] f32, the A tile [16][4 UB + 8] bf16
// (72,960 bytes at H = 256, 210,176 at H = 512).
__host__ __device__ constexpr size_t smem_bytes(int hid, int ub) {
  return (size_t)hid * u_pitch(ub) * 2 +
         (size_t)2 * kGroupRows * p_pitch(hid) * 4 +
         (size_t)kGroupRows * u_pitch(ub) * 2;
}

inline bool shape_ok(int hid, int ub) {
  return hid > 0 && hid % 8 == 0 && ub > 0 && ub % 8 == 0 &&
         ub <= kMaxUnits && (hid + ub - 1) / ub <= kMaxCluster &&
         smem_bytes(hid, ub) <= 232448;      // a block's shared memory
}

// Sets `kernel`'s attributes for (H, UB) and returns how many of its
// clusters the card holds at once, or -cudaError_t.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int hid, int ub) {
  return lstm_common::cluster_max_active(kernel, (hid + ub - 1) / ub,
                                         kGroupRows * ub,
                                         smem_bytes(hid, ub));
}

// Launches `kernel` with `args` on the clusters of CS blocks for the
// `n_rows` rows (one per 16) and `dirs` directions, after the check, once
// per (kernel, H, UB) -- the caller keeps `checked` -- that such a cluster
// fits the card. Fails, never degrades: cudaErrorInvalidValue for a shape
// the kernel does not take, cudaErrorInvalidConfiguration when no cluster
// fits.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int (&checked)[2], int hid, int ub, int n_rows,
           int dirs, cudaStream_t stream, Args... args) {
  if (!shape_ok(hid, ub)) return (int)cudaErrorInvalidValue;
  return lstm_common::cluster_launch(
      kernel, checked, hid, ub, (hid + ub - 1) / ub, kGroupRows * ub,
      smem_bytes(hid, ub), (n_rows + kGroupRows - 1) / kGroupRows, dirs,
      stream, args...);
}

// One direction's backward recurrence, run by every block of a cluster
// (blockIdx.y is the row group). dout, c_res: [T, N, H]; gates, dx
// (output): [T, N, 4H]; u: [H, 4H]; lens: [N]; db_part (output): [N, 4H]
// f32. `bw` is the BiLSTM's backward direction: t ascending, the carry
// from row t+1.
__device__ __forceinline__ void recurrence(
    const __nv_bfloat16* __restrict__ dout,
    const __nv_bfloat16* __restrict__ gates,
    const __nv_bfloat16* __restrict__ c_res,
    const __nv_bfloat16* __restrict__ u, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ dx, float* __restrict__ db_part, int t_len,
    int n_rows, int hid, int ub, bool bw) {
  using bf16 = __nv_bfloat16;
  using lstm_common::from_f32;
  using lstm_common::smem_addr;
  using lstm_common::to_f32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k_len = 4 * ub, ld = u_pitch(ub), p_ld = p_pitch(hid);
  const int four_h = 4 * hid;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* u_s = reinterpret_cast<bf16*>(smem);                     // [H][ld]
  float* p_s = reinterpret_cast<float*>(smem + (size_t)hid * ld * 2);
  bf16* a_s =                                                   // [16][ld]
      reinterpret_cast<bf16*>(p_s + 2 * kGroupRows * p_ld);

  // this block's columns of U, once for the whole sequence: row n, gate q,
  // unit j at u_s[n][q UB + j]; units past H zero-filled
  {
    const int cpg = ub / 8;                      // 16-byte chunks per gate
    const int cpr = 4 * cpg;                     // ... per row
    for (int i = tid; i < hid * cpr; i += blockDim.x) {
      const int row = i / cpr, q = (i % cpr) / cpg, c = (i % cpg) * 8;
      const int unit = rank * ub + c;
      const bool ok = unit < hid;
      lstm_common::cp_async16(
          smem_addr(u_s + row * ld + q * ub + c),
          ok ? u + (long long)row * four_h + q * hid + unit : u, ok);
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
  // step s's inputs, loaded one step ahead
  float g_nx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c_nx = 0.0f, do_nx = 0.0f;
  auto fetch = [&](int s) {
    const int t = bw ? s : t_len - 1 - s;
    if (!owns || s >= t_len || t >= len) return;
    const long long row = (long long)t * n_rows + n;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g_nx[q] = to_f32(gates[row * four_h + q * hid + k]);
    const int tp = bw ? t + 1 : t - 1;           // the step's incoming carry
    c_nx = (tp >= 0 && tp < t_len)
               ? to_f32(c_res[((long long)tp * n_rows + n) * hid + k])
               : 0.0f;
    do_nx = to_f32(dout[row * hid + k]);
  };
  fetch(0);

  // the mma: warp w owns the n8 tiles 4w .. 4w+3 of the H outputs
  const int mi = lane / 8, mj = lane % 8;
  const int n_tiles = hid / 8;

  for (int s = 0; s < t_len; ++s) {
    const int t = bw ? s : t_len - 1 - s;
    const int par = s & 1;
    const bool live = owns && t < len;
    const float gi = g_nx[0], gj = g_nx[1], gfo = g_nx[2], go = g_nx[3];
    const float c_prev = c_nx, d_out = do_nx;
    fetch(s + 1);

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

}  // namespace lstm_bwd_cluster
