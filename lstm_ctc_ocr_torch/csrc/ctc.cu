// CTC forward (alpha) and backward (beta + posterior) recursions for Hopper
// (sm_90a).
//
// Replaces the TPU kernels lstm_ctc_ocr_tpu/ops/ctc_pallas.py:_fwd_kernel
// (called through _run_forward) and :_bwd_kernel (through _run_backward),
// with their contracts: the class->state gather that makes g and the
// state->class scatter of the gradient stay outside, in tensor ops.
//
//   forward:  alpha[0,s]  = (s <= 1 ? g[0,s] : NEG) + valid[s]
//             alpha[t,s]  = max(g[t,s] + lse3(alpha[t-1,s], alpha[t-1,s-1],
//                               alpha[t-1,s-2] + skip[s]) + valid[s], NEG)
//             logz        = lse_s(alpha[T-1,s] + final[s])
//   backward: beta[T-1,s] = max(g[T-1,s] + final[s] + valid[s], NEG)
//             beta[t,s]   = max(g[t,s] + lse3(beta[t+1,s], beta[t+1,s+1],
//                               beta[t+1,s+2] + skip[s+2]) + valid[s], NEG)
//             grad[t,s]   = -exp(min(alpha + beta - g - logz, 0)), zero where
//                           that exponent is <= NEG/2, where t >= len, and
//                           for a whole example with logz <= NEG/2
//
// NEG = -1e30 is a finite stand-in for log 0. lse3 clamps its maximum to NEG
// before subtracting and returns NEG when the maximum is <= NEG/2, and every
// step clamps to NEG, so sums of NEG terms never grow towards -inf and no
// inf - inf appears. All math is f32 with expf/logf (no fast-math).
//
// What bounds it on an H100: a chain of T dependent steps of a few
// transcendental ops each; per example it reads g once and writes alphas
// (or grad) once, a few KB. It is latency-bound, far above its byte bound.
//
// Design: the TPU kernel put 8 examples on sublanes and S (padded to 128)
// on lanes and kept alpha in VMEM scratch across a fori_loop. Here rows of
// up to 64 states (labels of up to 31 characters: every tracked config;
// the main path has S = 13, longline S = 49) run one warp per example, a
// block of one warp: ctc_fwd_warp_kernel and ctc_bwd_warp_kernel (on an
// H100, blocks of several warps -- examples -- ran each warp's chain
// slower at S = 49, as the SM's warps contend for the steps' shared
// memory reads, and no faster at S = 13). Lane l holds alpha (beta) for
// the K consecutive states l K .. l K + K - 1 (K = 1 up to S = 32, 2 up
// to 64) in registers; the s-1 and s-2 (s+1 and s+2) neighbours come from
// the lane's own registers or from __shfl_up_sync (__shfl_down_sync), NEG
// past the warp's ends, so the step chain has no shared-memory round trip
// and no barrier. The example's rows reach shared memory ahead of the
// chain -- g for the forward, g and alphas for the backward -- through a
// ring of two stages of kChunk time steps each, filled with cp.async one
// chunk ahead (16-byte copies, each chunk shifted in its stage so that
// shared and global addresses agree mod 16, since a row of S floats is not
// 16-byte aligned for odd S), so the chain reads only shared memory, and
// any T fits in a bounded ring. alphas (grad) are stored straight to
// global memory with a predicated store, off the chain; the backward
// computes each step's gradient beside the next step's recursion. The
// forward's logZ is a warp reduction over the lanes' final states. The
// per-state arithmetic, its order and the masks are those of the block
// kernels, so both forms give the same bits.
//
// Longer rows take ctc_fwd_kernel and ctc_bwd_kernel: one block per
// example of S rounded up to a warp multiple, at most 1024 threads; thread i
// walks the states i, i + blockDim.x, ..., so any S runs (labels of any
// length; the TPU kernel's one 128-lane row stopped at 63 characters). The
// rows between steps go through global memory, where they stay in L1 and
// L2: the forward reads row t-1 of its own alphas output, the backward two
// rows of a beta scratch [N, 2, S] by the step's parity, one __syncthreads
// a step in both. The per-state arithmetic, its order and the masks are
// those of the warp kernels, so every form gives the same bits. The batch
// needs no padding in either form.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/ctc_cuda.py). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;  // threads of a block kernel's block
constexpr int kWarpMaxStates = 64;    // the warp kernels: 32 lanes x K <= 2
constexpr int kChunk = 16;            // time steps a ring stage holds

// Floats of one half (g or alphas) of a ring stage: kChunk rows of S, 3
// floats of slack for the shift that aligns its copy, rounded up to 16
// bytes.
__host__ __device__ constexpr int stage_floats(int s_len) {
  return (kChunk * s_len + 3 + 3) / 4 * 4;
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m > 0.5f * kNeg ? out : kNeg;
}

// One block of up to kMaxThreads threads per example; thread i walks the
// states i, i + blockDim.x, ... Row t of the alphas is computed from row t-1
// of the output itself: every thread writes its states of row t-1 before
// the step's __syncthreads and reads three of them after it.
__global__ void __launch_bounds__(kMaxThreads)
ctc_fwd_kernel(const float* __restrict__ g, const float* __restrict__ skip,
               const float* __restrict__ valid, const float* __restrict__ fin,
               float* __restrict__ logz, float* alphas, int t_len,
               int s_len) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sk = skip + (long long)n * s_len;
  const float* va = valid + (long long)n * s_len;
  const float* fi = fin + (long long)n * s_len;
  const float* gn = g + (long long)n * t_len * s_len;
  float* an = alphas + (long long)n * t_len * s_len;

  for (int s = tid; s < s_len; s += blockDim.x)
    an[s] = (s <= 1 ? gn[s] : kNeg) + va[s];
  for (int t = 1; t < t_len; ++t) {
    __syncthreads();                             // row t-1 is written
    const float* prev = an + (long long)(t - 1) * s_len;
    float* cur = an + (long long)t * s_len;
    const float* gt = gn + (long long)t * s_len;
    for (int s = tid; s < s_len; s += blockDim.x) {
      const float one = s >= 1 ? prev[s - 1] : kNeg;
      const float two = (s >= 2 ? prev[s - 2] : kNeg) + sk[s];
      cur[s] = fmaxf(gt[s] + lse3(prev[s], one, two) + va[s], kNeg);
    }
  }

  // logz over the final states: final is 0 on at most two states and NEG on
  // the rest, whose terms exp(. - ms) are exactly 0, so the first warp's
  // threads each sum a strided share of the row and thread 0 adds the 32
  __syncthreads();
  if (tid < 32) {
    const float* last = an + (long long)(t_len - 1) * s_len;
    float m = kNeg;
    for (int i = tid; i < s_len; i += 32) m = fmaxf(m, last[i] + fi[i]);
    for (int d = 16; d > 0; d >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    const float ms = fmaxf(m, kNeg);
    float sum = 0.0f;
    for (int i = tid; i < s_len; i += 32) sum += expf(last[i] + fi[i] - ms);
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    if (tid == 0) logz[n] = m > 0.5f * kNeg ? ms + logf(sum) : kNeg;
  }
}

// As ctc_fwd_kernel, walking t descending: beta rows go through the
// example's two rows of `beta` [N][2][S] (scratch, by the step's parity),
// and each thread writes the gradient of its states beside their beta.
__global__ void __launch_bounds__(kMaxThreads)
ctc_bwd_kernel(const float* __restrict__ g, const float* __restrict__ skip,
               const float* __restrict__ valid, const float* __restrict__ fin,
               const float* __restrict__ alphas,
               const float* __restrict__ logz, const int* __restrict__ lens,
               float* __restrict__ grad, float* beta, int t_len, int s_len) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sk = skip + (long long)n * s_len;
  const float* va = valid + (long long)n * s_len;
  const float* fi = fin + (long long)n * s_len;
  const float lz = logz[n];
  const float feasible = lz > 0.5f * kNeg ? 1.0f : 0.0f;
  const int len = lens[n];
  const float* gn = g + (long long)n * t_len * s_len;
  const float* an = alphas + (long long)n * t_len * s_len;
  float* dn = grad + (long long)n * t_len * s_len;
  float* bn = beta + (long long)n * 2 * s_len;

  for (int t = t_len - 1; t >= 0; --t) {
    const float* nxt = bn + ((t + 1) & 1) * s_len;
    float* cur = bn + (t & 1) * s_len;
    const float* gt = gn + (long long)t * s_len;
    const float* at = an + (long long)t * s_len;
    if (t < t_len - 1) __syncthreads();          // row t+1 is written
    for (int s = tid; s < s_len; s += blockDim.x) {
      float b;
      if (t == t_len - 1) {
        b = fmaxf(gt[s] + fi[s] + va[s], kNeg);
      } else {
        // additive mask at source s for the s -> s+2 hop: skip[s+2]
        const float sk_fwd = s + 2 < s_len ? sk[s + 2] : kNeg;
        const float one = s + 1 < s_len ? nxt[s + 1] : kNeg;
        const float two = (s + 2 < s_len ? nxt[s + 2] : kNeg) + sk_fwd;
        b = fmaxf(gt[s] + lse3(nxt[s], one, two) + va[s], kNeg);
      }
      cur[s] = b;
      const float lg = at[s] + b - gt[s] - lz;
      const float post = lg > 0.5f * kNeg ? expf(fminf(lg, 0.0f)) : 0.0f;
      const float live = t < len ? 1.0f : 0.0f;
      dn[(long long)t * s_len + s] = -post * feasible * live;
    }
  }
}

using lstm_common::cp_async_commit;
using lstm_common::smem_addr;

// 4-byte asynchronous copy global -> shared, completed by
// cp.async.wait_group (the 16-byte one is lstm_common::cp_async16).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      smem_addr(dst)), "l"(src));
}

// The float offset of p in its 16 bytes.
__device__ __forceinline__ int shift_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copies `count` floats from `src` into a ring stage `dst` (16-byte
// aligned, count + 3 floats long) at dst + shift_of(src), so that shared
// and global addresses agree mod 16 and all but the ragged ends go as
// 16-byte copies. Issued by the 32 lanes of a warp.
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           int count, int lane) {
  const int shift = shift_of(src);
  float* d = dst + shift;
  const int head = min((4 - shift) & 3, count);  // floats before 16 bytes
  const int vecs = (count - head) / 4;           // 16-byte copies
  const int tail = head + 4 * vecs;              // floats from here on
  if (lane < head) cp_async4(d + lane, src + lane);
  for (int i = lane; i < vecs; i += 32)
    lstm_common::cp_async16(smem_addr(d + head + 4 * i), src + head + 4 * i,
                            true);
  if (lane < count - tail) cp_async4(d + tail + lane, src + tail + lane);
}

// Stores v to p in the lanes where `on` holds, as one predicated
// instruction: a branch around the store would split the step into basic
// blocks that the compiler does not schedule into each other.
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"((unsigned)on));
}

// The forward for S <= 32 K: block n, one warp, owns example n, lane l
// the states l K + k. Chunk c of the ascending walk holds the steps lo(c) =
// c kChunk up to min(lo(c) + kChunk, T) - 1, staged as rows t - lo(c) of
// stage c % 2 (kChunk x S floats of g, shifted by stage_copy by up to 3
// floats). Chunks c and c+1 are in flight when chunk c starts; chunk c+2 is
// issued into the same stage once every lane has finished reading chunk c.
template <int K>
__global__ void __launch_bounds__(32)
ctc_fwd_warp_kernel(const float* __restrict__ g,
                    const float* __restrict__ skip,
                    const float* __restrict__ valid,
                    const float* __restrict__ fin, float* __restrict__ logz,
                    float* __restrict__ alphas, int t_len, int s_len) {
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int stage = stage_floats(s_len);         // floats of g
  extern __shared__ __align__(16) float mine[];  // [2][stage]
  const long long base = (long long)n * t_len * s_len;
  const float* gn = g + base;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;

  auto issue = [&](int c) {                      // chunk c into stage c % 2
    if (c < n_chunks) {
      const int lo = c * kChunk;
      const int count = (min(lo + kChunk, t_len) - lo) * s_len;
      stage_copy(mine + (c & 1) * stage, gn + (long long)lo * s_len, count,
                 lane);
    }
    cp_async_commit();                           // a group per chunk, even
  };                                             // an empty one
  auto rows_g = [&](int c) {                     // the rows of chunk c
    return mine + (c & 1) * stage +
           shift_of(gn + (long long)c * kChunk * s_len);
  };
  issue(0);
  issue(1);

  // per state: the s-2 -> s hop's additive mask skip[s], valid, final, and
  // the column a row is read at (clamped below S, so that the read needs no
  // branch: states past S take NEG in place of what they read)
  bool act[K];
  int col[K];
  float sk[K], va[K], fi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    act[k] = s < s_len;
    col[k] = min(s, s_len - 1);
    sk[k] = act[k] ? skip[(long long)n * s_len + s] : kNeg;
    va[k] = act[k] ? valid[(long long)n * s_len + s] : kNeg;
    fi[k] = act[k] ? fin[(long long)n * s_len + s] : kNeg;
  }
  // this lane's g of one step from its row in a stage
  auto read = [&](const float* gs, int row, float (&gt)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float gv = gs[row + col[k]];
      gt[k] = act[k] ? gv : kNeg;
    }
  };
  // this lane's alphas of one step, stored at row (alphas' row of the step)
  auto emit = [&](float* row, const float (&alpha)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) store_if(row + lane * K + k, alpha[k], act[k]);
  };

  // Step 0 is not clamped: states past 1 start at NEG + valid, which is
  // -2e30 where valid is NEG, as in the plain version.
  lstm_common::cp_async_wait<1>();               // this lane's part of chunk 0
  __syncwarp();                                  // ... and every lane's
  float alpha[K];
  float* alpha_row = alphas + base;              // alphas' row of step t
  {
    float g0[K];
    read(rows_g(0), 0, g0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      alpha[k] = (lane * K + k <= 1 ? g0[k] : kNeg) + va[k];
    emit(alpha_row, alpha);
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) {
      lstm_common::cp_async_wait<1>();           // this lane's part of c
      __syncwarp();                              // ... and every lane's
    }
    const int lo = c * kChunk;
    const int hi = min(lo + kChunk, t_len);
    const float* gs = rows_g(c);
    for (int t = c == 0 ? 1 : lo; t < hi; ++t) {
      float gt[K];
      read(gs, (t - lo) * s_len, gt);
      float pv[K];                               // the previous lane's
#pragma unroll                                   // states, NEG below lane 0
      for (int k = 0; k < K; ++k) {
        pv[k] = __shfl_up_sync(0xffffffffu, alpha[k], 1);
        if (lane == 0) pv[k] = kNeg;
      }
      float one[K], two[K];
      if constexpr (K == 1) {
        float pv2 = __shfl_up_sync(0xffffffffu, alpha[0], 2);
        if (lane < 2) pv2 = kNeg;
        one[0] = pv[0];
        two[0] = pv2;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          one[k] = k >= 1 ? alpha[k - 1] : pv[k - 1 + K];
          two[k] = k >= 2 ? alpha[k - 2] : pv[k - 2 + K];
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        alpha[k] =
            fmaxf(gt[k] + lse3(alpha[k], one[k], two[k] + sk[k]) + va[k], kNeg);
      alpha_row += s_len;
      emit(alpha_row, alpha);
    }
    __syncwarp();                                // stage c % 2 is read
    issue(c + 2);
  }

  // logZ over the final states: final is 0 on at most two states and NEG on
  // the rest (and past S), whose terms exp(. - ms) are exactly 0, so the
  // sum has the plain version's bits in any order
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = alpha[k] + fi[k];
  float m = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, x[k]);
  for (int d = 16; d > 0; d >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  const float ms = fmaxf(m, kNeg);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) sum += expf(x[k] - ms);
  for (int d = 16; d > 0; d >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, d);
  if (lane == 0) logz[n] = m > 0.5f * kNeg ? ms + logf(sum) : kNeg;
}

// The backward for S <= 32 K: block n, one warp, owns example n, lane l
// the states l K + k. Chunk c of the
// descending walk holds the steps hi(c) = T - 1 - c kChunk down to lo(c) =
// max(hi(c) - kChunk + 1, 0), staged as rows t - lo(c) of the stage c % 2:
// [g rows | alphas rows], kChunk x S floats each, each half shifted by
// stage_copy by up to 3 floats. Chunks c and c+1 are in
// flight when chunk c starts; chunk c+2 is issued into the same stage once
// every lane has finished reading chunk c. A step's gradient is computed in
// the next step, beside its recursion: both need only the step's beta, so
// the gradient's exp and store fill the recursion chain's stalls.
template <int K>
__global__ void __launch_bounds__(32)
ctc_bwd_warp_kernel(const float* __restrict__ g,
                    const float* __restrict__ skip,
                    const float* __restrict__ valid,
                    const float* __restrict__ fin,
                    const float* __restrict__ alphas,
                    const float* __restrict__ logz,
                    const int* __restrict__ lens, float* __restrict__ grad,
                    int t_len, int s_len) {
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int stage = stage_floats(s_len);         // floats of g (or alphas)
  extern __shared__ __align__(16) float mine[];  // [2][2][stage]
  const long long base = (long long)n * t_len * s_len;
  const float* gn = g + base;
  const float* an = alphas + base;
  float* dn = grad + base;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;

  // chunk c: the steps hi(c) down to lo(c), into stage c % 2
  auto chunk_lo = [&](int c) { return max(t_len - (c + 1) * kChunk, 0); };
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int lo = chunk_lo(c);
      const long long off = (long long)lo * s_len;
      const int count = (t_len - c * kChunk - lo) * s_len;
      float* dst = mine + (c & 1) * 2 * stage;
      stage_copy(dst, gn + off, count, lane);
      stage_copy(dst + stage, an + off, count, lane);
    }
    cp_async_commit();                           // a group per chunk, even
  };                                             // an empty one
  // the rows of chunk c in its stage: g and alphas
  auto rows_g = [&](int c) {
    return mine + (c & 1) * 2 * stage +
           shift_of(gn + (long long)chunk_lo(c) * s_len);
  };
  auto rows_a = [&](int c) {
    return mine + ((c & 1) * 2 + 1) * stage +
           shift_of(an + (long long)chunk_lo(c) * s_len);
  };
  issue(0);
  issue(1);

  // per state: the s -> s+2 hop's additive mask skip[s+2], valid, final,
  // and the column a row is read at (clamped below S, so that the read
  // needs no branch: states past S take NEG in place of what they read)
  bool act[K];
  int col[K];
  float sk_fwd[K], va[K], fi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    act[k] = s < s_len;
    col[k] = min(s, s_len - 1);
    sk_fwd[k] = (s + 2 < s_len) ? skip[(long long)n * s_len + s + 2] : kNeg;
    va[k] = act[k] ? valid[(long long)n * s_len + s] : kNeg;
    fi[k] = act[k] ? fin[(long long)n * s_len + s] : kNeg;
  }
  const float lz = logz[n];
  const float feasible = lz > 0.5f * kNeg ? 1.0f : 0.0f;
  const int len = lens[n];

  // One step of the recursion for this lane's states, from the next
  // step's beta and this step's g.
  auto step = [&](const float (&beta)[K], const float (&gt)[K],
                  float (&nb)[K]) {
    float nx[K];                                 // the next lane's states,
#pragma unroll                                   // NEG past the warp
    for (int k = 0; k < K; ++k) {
      nx[k] = __shfl_down_sync(0xffffffffu, beta[k], 1);
      if (lane == 31) nx[k] = kNeg;
    }
    float one[K], two[K];
    if constexpr (K == 1) {
      float nx2 = __shfl_down_sync(0xffffffffu, beta[0], 2);
      if (lane >= 30) nx2 = kNeg;
      one[0] = nx[0];
      two[0] = nx2;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        one[k] = k + 1 < K ? beta[k + 1] : nx[k + 1 - K];
        two[k] = k + 2 < K ? beta[k + 2] : nx[k + 2 - K];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      nb[k] = fmaxf(gt[k] + lse3(beta[k], one[k], two[k] + sk_fwd[k]) + va[k],
                    kNeg);
  };
  // The gradient of step t from its beta, g and alphas, stored straight to
  // global memory at row, grad's row of step t.
  auto emit = [&](int t, float* row, const float (&beta)[K],
                  const float (&gt)[K], const float (&at)[K]) {
    const float live = t < len ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float lg = at[k] + beta[k] - gt[k] - lz;
      const float e = expf(fminf(lg, 0.0f));
      const float post = lg > 0.5f * kNeg ? e : 0.0f;
      store_if(row + lane * K + k, -post * feasible * live, act[k]);
    }
  };
  // this lane's g and alphas of one step from its rows in a stage
  auto read = [&](const float* gs, const float* as, int row, float (&gt)[K],
                  float (&at)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float gv = gs[row + col[k]], av = as[row + col[k]];
      gt[k] = act[k] ? gv : kNeg;
      at[k] = act[k] ? av : kNeg;
    }
  };

  // Step T-1 starts the walk; every later step t computes beta[t] and, off
  // that chain, step t+1's gradient, which needs only beta[t+1]: the two
  // interleave in one basic block.
  lstm_common::cp_async_wait<1>();               // this lane's part of chunk 0
  __syncwarp();                                  // ... and every lane's
  float beta[K], gp[K], ap[K];                   // beta, g, alphas of step tp
  int tp = t_len - 1;
  float* grad_row = dn + (long long)tp * s_len;  // grad's row of step tp
  read(rows_g(0), rows_a(0), (t_len - 1 - chunk_lo(0)) * s_len, gp, ap);
#pragma unroll
  for (int k = 0; k < K; ++k) beta[k] = fmaxf(gp[k] + fi[k] + va[k], kNeg);
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) {
      lstm_common::cp_async_wait<1>();           // this lane's part of c
      __syncwarp();                              // ... and every lane's
    }
    const int hi = t_len - 1 - c * kChunk;
    const int lo = chunk_lo(c);
    const float* gs = rows_g(c);
    const float* as = rows_a(c);
    for (int t = c == 0 ? hi - 1 : hi; t >= lo; --t) {
      float gt[K], at[K], nb[K];
      read(gs, as, (t - lo) * s_len, gt, at);
      step(beta, gt, nb);
      emit(tp, grad_row, beta, gp, ap);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        beta[k] = nb[k];
        gp[k] = gt[k];
        ap[k] = at[k];
      }
      tp = t;
      grad_row -= s_len;
    }
    __syncwarp();                                // stage c % 2 is read
    issue(c + 2);
  }
  emit(tp, grad_row, beta, gp, ap);              // step 0
}

int block_threads(int s_len) {
  return min(((s_len + 31) / 32) * 32, kMaxThreads);
}

template <int K>
int launch_fwd_warp(const void* g, const void* skip, const void* valid,
                    const void* fin, void* logz, void* alphas, int n_rows,
                    int t_len, int s_len, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * stage_floats(s_len);
  ctc_fwd_warp_kernel<K><<<n_rows, 32, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(skip),
      static_cast<const float*>(valid), static_cast<const float*>(fin),
      static_cast<float*>(logz), static_cast<float*>(alphas), t_len, s_len);
  return (int)cudaGetLastError();
}

template <int K>
int launch_bwd_warp(const void* g, const void* skip, const void* valid,
                    const void* fin, const void* alphas, const void* logz,
                    const void* lens, void* grad, int n_rows, int t_len,
                    int s_len, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * stage_floats(s_len);
  ctc_bwd_warp_kernel<K><<<n_rows, 32, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(skip),
      static_cast<const float*>(valid), static_cast<const float*>(fin),
      static_cast<const float*>(alphas), static_cast<const float*>(logz),
      static_cast<const int*>(lens), static_cast<float*>(grad), t_len, s_len);
  return (int)cudaGetLastError();
}

}  // namespace

// g, alphas: [N, T, S] f32; skip, valid, fin: [N, S] f32 additive masks;
// logz: [N] f32. S <= 32 and S <= 64 run the warp kernel (K = 1, 2),
// longer rows the block kernel. Returns a cudaError_t.
extern "C" int ctc_fwd(const void* g, const void* skip, const void* valid,
                       const void* fin, void* logz, void* alphas, int n_rows,
                       int t_len, int s_len, void* stream) {
  if (n_rows <= 0 || t_len <= 0 || s_len <= 0)
    return (int)cudaErrorInvalidValue;
  if (s_len <= kWarpMaxStates) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return s_len <= 32
               ? launch_fwd_warp<1>(g, skip, valid, fin, logz, alphas, n_rows,
                                    t_len, s_len, st)
               : launch_fwd_warp<2>(g, skip, valid, fin, logz, alphas, n_rows,
                                    t_len, s_len, st);
  }
  ctc_fwd_kernel<<<n_rows, block_threads(s_len), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(skip),
      static_cast<const float*>(valid), static_cast<const float*>(fin),
      static_cast<float*>(logz), static_cast<float*>(alphas), t_len, s_len);
  return (int)cudaGetLastError();
}

// As ctc_fwd, plus lens: [N] int32, grad: [N, T, S] f32 (output) and beta:
// scratch [N, 2, S] f32 for the block kernel (null up to S = 64). S <= 32
// and S <= 64 run the warp kernel (K = 1, 2), longer rows the block kernel.
extern "C" int ctc_bwd(const void* g, const void* skip, const void* valid,
                       const void* fin, const void* alphas, const void* logz,
                       const void* lens, void* grad, void* beta, int n_rows,
                       int t_len, int s_len, void* stream) {
  if (n_rows <= 0 || t_len <= 0 || s_len <= 0 ||
      (s_len > kWarpMaxStates && beta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (s_len <= kWarpMaxStates) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return s_len <= 32
               ? launch_bwd_warp<1>(g, skip, valid, fin, alphas, logz, lens,
                                    grad, n_rows, t_len, s_len, st)
               : launch_bwd_warp<2>(g, skip, valid, fin, alphas, logz, lens,
                                    grad, n_rows, t_len, s_len, st);
  }
  ctc_bwd_kernel<<<n_rows, block_threads(s_len), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(skip),
      static_cast<const float*>(valid), static_cast<const float*>(fin),
      static_cast<const float*>(alphas), static_cast<const float*>(logz),
      static_cast<const int*>(lens), static_cast<float*>(grad),
      static_cast<float*>(beta), t_len, s_len);
  return (int)cudaGetLastError();
}
