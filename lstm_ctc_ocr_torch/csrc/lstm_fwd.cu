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
// eighteen times a block's 227 KB of shared memory. The card's bound is
// far below the chain (0.003 ms of bytes at T = 23, N = 64): what costs
// time is how often U crosses from L2 and how long one step's dependent
// chain is. Dispatch by type is explicit:
//
// bf16 (the type both models train and decode in) -- lstm_fwd_cluster_kernel,
// the cluster recurrence of lstm_fwd_cluster.cuh: one thread-block cluster
// of CS <= 16 blocks per 16 batch rows, each block's 4 UB columns of U in
// its shared memory for the whole sequence (128 KB at H = 512), each step's
// product on tensor cores (mma.sync), the new h exchanged through
// distributed shared memory with one cluster barrier a step. It replaced
// the one-block-per-row kernel below for bf16, which re-read all of U (2 MB)
// from L2 in every block and step and ran the product as FP32 FMAs. Batch
// 64 is four clusters of 16 blocks at 190 KB of shared memory each (one
// block an SM); what bounds it now is the step's chain: the product's
// shared-memory reads (256 KB a block and step, ~2,000 cycles at 128 bytes
// a cycle), the cluster barrier and the 16 KB pull of h through
// distributed shared memory. On an H100 at 700 W a step takes ~3.7 us, of
// which tools/ablate_lstm_fwd.py puts ~1.1 in the product, ~0.7 in the
// cluster barrier, ~0.55 in the remote part of the pull and ~1.4 in the
// gate math, the stores and the block barriers. The launch checks
// cudaOccupancyMaxActiveClusters and fails where no cluster of the shape
// fits (the wrapper raises); it never degrades to another kernel. The
// wrapper hands U as it is: the cluster's copy into shared memory gathers
// each block's columns, so no call packs U with torch ops any more (the
// one-block-per-row kernel needed a repacked U on every call).
//
// f32 -- lstm_fwd_kernel, one block per batch row (f32 U, 4 MB, fits no
// cluster, and a tensor-core product would be TF32): H threads (up to 512,
// so at most 128 registers a thread); thread k owns hidden unit k, computes
// its four gate columns k, H+k, 2H+k, 3H+k, and keeps that unit's h and c
// in registers, so the gate math and the state update are thread-local.
// The row's h sits in shared memory, two __syncthreads per step. The
// wrapper hands U packed as [H/VEC][4H][VEC] (VEC = 4 floats, 16 bytes),
// so one 16-byte load per thread and gate brings VEC consecutive rows of U
// and a warp's loads cover 512 contiguous bytes; the loop over those
// loads is unrolled 4 deep to keep several in flight. Every block re-reads
// U from L2 each step.
//
// The TPU carried h/c in VMEM scratch across a sequential grid of time
// blocks, with the time and batch axes padded to its tiles; here the time
// loop lives inside the block and nothing is padded.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). Each entry point launches on the
// given stream, does not synchronise, and returns a cudaError_t.

#include "lstm_common.cuh"
#include "lstm_fwd_cluster.cuh"

namespace {

using lstm_common::sigmoid_f32;

constexpr int kMaxHidden = 512;  // H: threads per f32 block

// --- bf16: the cluster recurrence (lstm_fwd_cluster.cuh) -------------------

__global__ void __launch_bounds__(lstm_fwd_cluster::kMaxThreads)
lstm_fwd_cluster_kernel(const __nv_bfloat16* __restrict__ xp,
                        const __nv_bfloat16* __restrict__ u,
                        const __nv_bfloat16* __restrict__ bias,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ out,
                        __nv_bfloat16* __restrict__ g_out,
                        __nv_bfloat16* __restrict__ h_out,
                        __nv_bfloat16* __restrict__ c_out, int t_len,
                        int n_rows, int hid, int ub, float forget_bias) {
  lstm_fwd_cluster::recurrence(xp, 4LL * hid, u, bias, lens, out, g_out,
                               h_out, c_out, t_len, n_rows, hid, ub,
                               forget_bias, false);
}

// --- f32: one block per batch row ------------------------------------------

__global__ void __launch_bounds__(kMaxHidden)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ u,
                const float* __restrict__ bias, const int* __restrict__ lens,
                float* __restrict__ out, float* __restrict__ g_out,
                float* __restrict__ h_out, float* __restrict__ c_out,
                int t_len, int n_rows, int hid, float forget_bias) {
  constexpr int VEC = 4;                         // floats per 16 bytes
  const bool save = g_out != nullptr;
  const int k = threadIdx.x;                     // hidden unit
  const int n = blockIdx.x;                      // batch row
  const int four_h = 4 * hid;
  const int len = lens[n];

  extern __shared__ float h_row[];               // [hid]

  float h = 0.0f, c = 0.0f;
  h_row[k] = 0.0f;
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = bias[g * hid + k];
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const long long row = (long long)t * n_rows + n;
    const float* x_row = xp + row * four_h;
    float acc[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[g] = x_row[g * hid + k];

    // acc[g] += sum_kk h_row[kk] * U[kk][g*hid + k]
#pragma unroll 4
    for (int kb = 0; kb < hid / VEC; ++kb) {
      alignas(16) float uv[4][VEC];
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
          acc[g] = fmaf(hv, uv[g][v], acc[g]);
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
    out[row * hid + k] = live ? h_new : 0.0f;
    if (save) {
      float* g_row = g_out + row * four_h;
      g_row[k] = gi;
      g_row[hid + k] = gj;
      g_row[2 * hid + k] = gfo;
      g_row[3 * hid + k] = go;
      h_out[row * hid + k] = h;
      c_out[row * hid + k] = c;
    }
    __syncthreads();                             // all reads of h_row done
    h_row[k] = h;
    __syncthreads();
  }
}

}  // namespace

// Dynamic shared memory of one bf16 cluster block at (H, UB), in bytes (for
// reports).
extern "C" int lstm_fwd_cluster_smem(int hid, int ub) {
  return (int)lstm_fwd_cluster::smem_bytes(hid, ub);
}

// How many clusters of the bf16 recurrence at (H, UB) the card holds at
// once (cudaOccupancyMaxActiveClusters; for reports), or -cudaError_t.
extern "C" int lstm_fwd_max_clusters(int hid, int ub) {
  if (!lstm_fwd_cluster::shape_ok(hid, ub))
    return -(int)cudaErrorInvalidValue;
  return lstm_fwd_cluster::max_active_clusters(lstm_fwd_cluster_kernel, hid,
                                               ub);
}

// xp: [T, N, 4H] contiguous; u: U [H, 4H] as it is; bias: [4H]; lens: [N]
// int32; out: [T, N, H]. g_out ([T, N, 4H]), h_out and c_out ([T, N, H])
// are null unless residuals are saved. ub: hidden units a cluster block
// owns (a multiple of 8, ceil(H / ub) <= 16). H a multiple of 8, <= 512.
// Returns a cudaError_t (cudaErrorInvalidConfiguration when no cluster of
// ceil(H / ub) blocks fits on the card).
extern "C" int lstm_fwd_bf16(const void* xp, const void* u, const void* bias,
                             const void* lens, void* out, void* g_out,
                             void* h_out, void* c_out, int t_len, int n_rows,
                             int hid, int ub, float forget_bias,
                             void* stream) {
  using bf16 = __nv_bfloat16;
  if (t_len <= 0 || n_rows <= 0 || hid > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  static int checked[2] = {-1, -1};
  return lstm_fwd_cluster::launch(
      lstm_fwd_cluster_kernel, checked, hid, ub, n_rows, 1,
      static_cast<cudaStream_t>(stream), static_cast<const bf16*>(xp),
      static_cast<const bf16*>(u), static_cast<const bf16*>(bias),
      static_cast<const int*>(lens), static_cast<bf16*>(out),
      static_cast<bf16*>(g_out), static_cast<bf16*>(h_out),
      static_cast<bf16*>(c_out), t_len, n_rows, hid, ub, forget_bias);
}

// As lstm_fwd_bf16 without ub, with u: U packed as [H/4][4H][4]. Returns a
// cudaError_t.
extern "C" int lstm_fwd_f32(const void* xp, const void* u, const void* bias,
                            const void* lens, void* out, void* g_out,
                            void* h_out, void* c_out, int t_len, int n_rows,
                            int hid, float forget_bias, void* stream) {
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden || hid % 4)
    return (int)cudaErrorInvalidValue;
  lstm_fwd_kernel<<<n_rows, hid, sizeof(float) * hid,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(u),
      static_cast<const float*>(bias), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(g_out),
      static_cast<float*>(h_out), static_cast<float*>(c_out), t_len, n_rows,
      hid, forget_bias);
  return (int)cudaGetLastError();
}
