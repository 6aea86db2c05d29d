// The bf16 recurrence shared by the two LSTM forward kernels for Hopper
// (sm_90a): lstm_fwd.cu (kernel 5, one direction) and bilstm_fwd.cu
// (kernel 1, both directions in one launch), each up to H = 512; wider H
// runs the wide recurrence of lstm_wide.cuh. Their f32 paths keep their
// one-block-per-row kernels.
//
// Geometry. The batch rows go in groups of 16 (the mma M); each group is
// one thread-block cluster of CS blocks, and block b owns the UB hidden
// units [b UB, (b+1) UB) (UB = 8 ceil(H / 128), CS = ceil(H / UB) <= 16, as
// in lstm_bwd.cu: 16 blocks of 32 units at H = 512, 16 of 16 at H = 256).
// A block has 16 UB threads; thread (r, j) owns row r of the group and unit
// b UB + j, keeps that unit's h and c in f32 registers and does its gate
// math, as thread k did in the one-block-per-row kernels.
//
// U on chip. Block b copies its 4 UB gate columns of U -- U[k, q H + b UB
// + j] for the gates q and all rows k -- into shared memory once, with
// cp.async straight from U [H, 4H] (zero past H), and keeps them for the
// whole sequence. That image is rnn_cuda.pack_u_slices(U, UB)[b], [H][4 UB]
// (128 KB at H = 512), gathered by the copy itself: the wrapper hands U as
// it is, so a call packs nothing with torch ops and launches nothing but
// the recurrence. U crosses L2 once per cluster and launch, not once per
// block and step.
//
// A step (one cluster barrier, split in two, and two block barriers):
//  1. Product. g[:, cols] = h_{t-1} [16, H] U_b [H, 4 UB] with mma.sync
//     m16n8k16 (bf16 in, f32 accumulators). Warp w owns 32 of the 4 UB
//     columns (four n8 tiles) and a quarter of the depth, so it reads a
//     quarter of the A tile and 1/16 of U_b from shared memory (ldmatrix;
//     U_b, stored k-major, through ldmatrix.trans). The four quarter-depth
//     partial products go to shared memory and are summed in a fixed
//     order: deterministic, no atomics. (One warp per n8 tile over the
//     whole depth would read the whole A tile in every warp: 384 KB of
//     shared memory a step against 256 KB.)
//  2. Gate math. Thread (r, j) adds the partials, x_proj[t] (loaded one
//     step ahead) and the bias, does the gate math and the masked c/h
//     update in f32, and writes out and, with residuals, the gates and the
//     h and c carries, as the f32 kernels do. A dead row (len <= t) keeps
//     its state and writes a zero output; it still takes part in the
//     product, so no branch diverges across the cluster.
//  3. Exchange. Each block writes its new h slice [16][UB], rounded to
//     bf16 as the product takes it, into its own buffer, double-buffered
//     by the step's parity, and arrives at the cluster barrier; then it
//     stores out and the residuals to global memory and waits at the
//     barrier, so those stores overlap the barrier and its release covers
//     only the shared-memory slice; then each block pulls the CS slices
//     into its A tile [16][H] through distributed shared memory, 16 bytes a
//     load (16 KB a block and step at H = 512; at most two loads a
//     thread, whose addresses are computed once before the time loop).
//     Pulling was kept over pushing with remote stores: a push needs a
//     double-buffered A tile, since it lands in the reader's shared memory
//     while the reader may still be reading, and in the LSTM backward
//     (lstm_bwd.cu) pushed partial products measured slower than pulled
//     ones.
// The h slice buffers are written at step s and read by the cluster after
// the barrier of step s; the next write to the same buffer, at s + 2,
// comes after the barrier of step s + 1, which no block passes before the
// whole cluster has finished its pulls of step s. The last step pulls
// nothing, so no block reads another's shared memory after the final
// barrier, and a block may leave as soon as it passes it.

#pragma once

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace lstm_fwd_cluster {

namespace cg = cooperative_groups;

// The cluster barrier in its two halves: arrive publishes this thread's
// earlier shared-memory writes to the cluster (release), wait returns once
// every thread of the cluster has arrived (acquire).
__device__ __forceinline__ void arrive_cluster() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_cluster() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kGroupRows = 16;    // batch rows per cluster: the mma M
constexpr int kMaxCluster = 16;   // blocks per cluster (non-portable above 8)
constexpr int kMaxUnits = 32;     // hidden units per cluster block
constexpr int kSplits = 4;        // depth quarters: warps per column group
constexpr int kMaxDepth = 512;    // H rounded up to the k16 steps
constexpr int kMaxThreads = kGroupRows * kMaxUnits;

// The product's depth: the CS UB units of the A tile, rounded up to 16.
__host__ __device__ constexpr int depth(int hid, int ub) {
  return ((hid + ub - 1) / ub * ub + 15) / 16 * 16;
}
// Shared-memory pitches, in elements; each pad keeps ldmatrix (rows 16
// bytes apart in the bank space) or the partials' float2 stores free of
// bank conflicts.
__host__ __device__ constexpr int u_pitch(int ub) { return 4 * ub + 8; }
__host__ __device__ constexpr int a_pitch(int kp) { return kp + 8; }
__host__ __device__ constexpr int p_pitch(int ub) { return 4 * ub + 16; }

// Shared memory of one cluster block: U's columns [Kp][4 UB + 8] bf16, the
// A tile [16][Kp + 8] bf16, the partial products [4][16][4 UB + 16] f32 and
// the h slices [2][16][UB] bf16.
__host__ __device__ constexpr size_t smem_bytes(int hid, int ub) {
  return (size_t)depth(hid, ub) * u_pitch(ub) * 2 +
         (size_t)kGroupRows * a_pitch(depth(hid, ub)) * 2 +
         (size_t)kSplits * kGroupRows * p_pitch(ub) * 4 +
         (size_t)2 * kGroupRows * ub * 2;
}

inline bool shape_ok(int hid, int ub) {
  return hid > 0 && hid % 8 == 0 && ub > 0 && ub % 8 == 0 &&
         ub <= kMaxUnits && (hid + ub - 1) / ub <= kMaxCluster &&
         depth(hid, ub) <= kMaxDepth &&
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

// One direction's recurrence, run by every block of a cluster (blockIdx.y
// is the row group). xp: [T, N, 4H] rows x_stride elements apart; u: [H,
// 4H]; bias: [4H]; lens: [N]; out: [T, N, H]; g_out ([T, N, 4H]), h_out and
// c_out ([T, N, H]) null unless residuals are saved. `reverse` walks t
// descending (the BiLSTM's backward direction: with the same mask this
// equals the length-reversed sequence).
__device__ __forceinline__ void recurrence(
    const __nv_bfloat16* __restrict__ xp, long long x_stride,
    const __nv_bfloat16* __restrict__ u,
    const __nv_bfloat16* __restrict__ bias, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ g_out,
    __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ c_out,
    int t_len, int n_rows, int hid, int ub, float forget_bias, bool reverse) {
  using bf16 = __nv_bfloat16;
  using lstm_common::from_f32;
  using lstm_common::sigmoid_f32;
  using lstm_common::smem_addr;
  using lstm_common::to_f32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kp = depth(hid, ub);
  const int ldu = u_pitch(ub), lda = a_pitch(kp), ldp = p_pitch(ub);
  const int four_h = 4 * hid;
  const bool save = g_out != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* u_s = reinterpret_cast<bf16*>(smem);                    // [Kp][ldu]
  bf16* a_s = u_s + (size_t)kp * ldu;                           // [16][lda]
  float* p_s = reinterpret_cast<float*>(a_s + kGroupRows * lda);
  bf16* h_s = reinterpret_cast<bf16*>(p_s + kSplits * kGroupRows * ldp);

  // this block's columns of U, once for the whole sequence: row k, gate q,
  // unit j at u_s[k][q UB + j]; rows past H and units past H zero-filled
  {
    const int cpg = ub / 8;                      // 16-byte chunks per gate
    const int cpr = 4 * cpg;                     // ... per row
    for (int i = tid; i < kp * cpr; i += blockDim.x) {
      const int k = i / cpr, q = (i % cpr) / cpg, j = (i % cpg) * 8;
      const int unit = rank * ub + j;
      const bool ok = k < hid && unit < hid;
      lstm_common::cp_async16(
          smem_addr(u_s + k * ldu + q * ub + j),
          ok ? u + (long long)k * four_h + q * hid + unit : u, ok);
    }
    lstm_common::cp_async_commit();
  }
  // h_{-1} = 0; the A tile's columns past CS UB stay zero throughout
  for (int i = tid; i < kGroupRows * lda / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(a_s)[i] = make_uint4(0, 0, 0, 0);

  // this thread's (row, unit)
  const int r = tid / ub, j = tid % ub;
  const int k = rank * ub + j;                   // hidden unit
  const int n = blockIdx.y * kGroupRows + r;     // batch row
  const bool owns = n < n_rows && k < hid;
  const int len = owns ? lens[n] : 0;
  float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (owns) {
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = to_f32(bias[q * hid + k]);
  }
  float h = 0.0f, c = 0.0f;
  // step s's input projection, loaded one step ahead
  float x_nx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto fetch = [&](int s) {
    if (!owns || s >= t_len) return;
    const int t = reverse ? t_len - 1 - s : s;
    const bf16* row = xp + ((long long)t * n_rows + n) * x_stride;
#pragma unroll
    for (int q = 0; q < 4; ++q) x_nx[q] = to_f32(row[q * hid + k]);
  };
  fetch(0);

  // the product: warp w owns the 32 columns [32 (w / 4), +32) and the
  // depth quarter w % 4, `per` k16 steps of the Kp / 16
  const int split = warp % kSplits, col0 = (warp / kSplits) * 32;
  const int n_steps = kp / 16;
  const int per = (n_steps + kSplits - 1) / kSplits;
  const int mi = lane / 8, mj = lane % 8;        // ldmatrix: matrix, row
  float* p_out = p_s + split * kGroupRows * ldp;

  // the exchange's pull: CS x 16 rows x UB / 8 chunks of 16 bytes, at
  // most two a thread (CS <= 16). Chunk i comes from row (i % (16 UB / 8))
  // / (UB / 8) of block i / (16 UB / 8)'s h slices (step parity 0; parity
  // 1 is 16 UB elements on). Its addresses are fixed for the sequence and
  // computed here once: the runtime divisions cost ~0.5 us a step inside
  // the loop.
  const bf16* pull_src[2] = {h_s, h_s};
  int pull_dst[2] = {0, 0};
  int n_pull = 0;
  {
    const int cpb = ub / 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * (int)blockDim.x;
      if (i < cs * kGroupRows * cpb) {
        const int src = i / (kGroupRows * cpb);
        const int rem = i % (kGroupRows * cpb);
        pull_src[e] = cluster.map_shared_rank(h_s, src) + (rem / cpb) * ub +
                      (rem % cpb) * 8;
        pull_dst[e] = (rem / cpb) * lda + src * ub + (rem % cpb) * 8;
        n_pull = e + 1;
      }
    }
  }
  lstm_common::cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = reverse ? t_len - 1 - s : s;
    const int par = s & 1;
    const float x0 = x_nx[0], x1 = x_nx[1], x2 = x_nx[2], x3 = x_nx[3];
    fetch(s + 1);

    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxDepth / 16 / kSplits; ++i) {  // unrolled:
        const int ks = split * per + i;                     // fragment loads
        if (i >= per || ks >= n_steps) break;               // overlap mmas
        const int kk = ks * 16;
        uint32_t af[4], bq[2][4];
        lstm_common::ldmatrix_x4(
            af, smem_addr(a_s + (lane % 16) * lda + kk + (lane / 16) * 8));
#pragma unroll
        for (int p = 0; p < 2; ++p)              // B = U_b: depth k, column
          lstm_common::ldmatrix_x4_trans(
              bq[p], smem_addr(u_s + (kk + (mi % 2) * 8 + mj) * ldu + col0 +
                               p * 16 + (mi / 2) * 8));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          lstm_common::mma_bf16(acc[nt], af, bq[nt / 2][(nt % 2) * 2],
                                bq[nt / 2][(nt % 2) * 2 + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = col0 + nt * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(p_out + (lane / 4) * ldp + col) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(p_out + (lane / 4 + 8) * ldp + col) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();

    // gate math for (row r, unit k): the partials in ascending order
    float g[4];
    const float xq[4] = {x0, x1, x2, x3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* col = p_s + r * ldp + q * ub + j;
      float sum = col[0];
#pragma unroll
      for (int sp = 1; sp < kSplits; ++sp) sum += col[sp * kGroupRows * ldp];
      g[q] = sum + xq[q] + b[q];
    }
    const float gi = sigmoid_f32(g[0]);
    const float gj = tanhf(g[1]);
    const float gfo = sigmoid_f32(g[2] + forget_bias);
    const float go = sigmoid_f32(g[3]);
    const float c_new = gfo * c + gi * gj;
    const float h_new = go * tanhf(c_new);
    const bool live = t < len;                   // false for a non-owner
    if (live) {
      h = h_new;
      c = c_new;
    }
    bf16* mine = h_s + par * kGroupRows * ub;
    mine[r * ub + j] = from_f32<bf16>(h);
    arrive_cluster();
    if (owns) {
      const long long row = (long long)t * n_rows + n;
      out[row * hid + k] = from_f32<bf16>(live ? h_new : 0.0f);
      if (save) {
        bf16* g_row = g_out + row * four_h;
        g_row[k] = from_f32<bf16>(gi);
        g_row[hid + k] = from_f32<bf16>(gj);
        g_row[2 * hid + k] = from_f32<bf16>(gfo);
        g_row[3 * hid + k] = from_f32<bf16>(go);
        h_out[row * hid + k] = from_f32<bf16>(h);
        c_out[row * hid + k] = from_f32<bf16>(c);
      }
    }
    wait_cluster();

    if (s + 1 < t_len) {                         // pull the new h
      const int off = par * kGroupRows * ub;
      uint4 v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (e < n_pull)
          v[e] = *reinterpret_cast<const uint4*>(pull_src[e] + off);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (e < n_pull) *reinterpret_cast<uint4*>(a_s + pull_dst[e]) = v[e];
      __syncthreads();
    }
  }
}

}  // namespace lstm_fwd_cluster
