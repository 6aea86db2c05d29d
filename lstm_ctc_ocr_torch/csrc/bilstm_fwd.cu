// Fused masked bidirectional LSTM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel lstm_ctc_ocr_tpu/ops/rnn_pallas.py:_bi_fwd_kernel
// (called through _bi_fwd_call). Both directions run in one launch: the
// forward direction walks physical time ascending, the backward direction
// descending, and a row whose length is <= t leaves its state untouched and
// writes a zero output. That masked descending walk equals running the
// backward cell over the length-reversed sequence (tf.reverse_sequence), so
// no reversal gathers are needed.
//
// Per step and direction the math is, with g = x_proj[t] + h_{t-1} U + b:
//   i = sigmoid(g_i), j = tanh(g_j), f = sigmoid(g_f + forget_bias),
//   o = sigmoid(g_o), c = f c + i j, h = o tanh(c)          (gate order i,j,f,o)
// h and c are carried in f32; h enters the product rounded to the input
// type, as the TPU kernel casts it; products accumulate in f32.
//
// What bounds it on an H100: a serial chain of T dependent steps, each a
// [rows, H] x [H, 4H] product per direction. At H = 256, U is 512 KB (bf16)
// per direction, more than a block's 227 KB of shared memory. The card's
// bound is far below the chain (0.003 ms of bytes at T = 23, N = 64): what
// costs time is how often U crosses from L2 and how long one step's
// dependent chain is. Dispatch by type is explicit:
//
// bf16 (the type both models train and decode in) --
// bilstm_fwd_cluster_kernel, the cluster recurrence of lstm_fwd_cluster.cuh
// that kernel 5 (lstm_fwd.cu) runs too: one thread-block cluster of CS
// blocks per 16 batch rows and direction (blockIdx.z), each block's 4 UB
// columns of its direction's U in shared memory for the whole sequence
// (32 KB at H = 256: CS = 16 blocks of UB = 16 units), each step's product
// on tensor cores (mma.sync), the new h exchanged through distributed
// shared memory with one cluster barrier a step. The backward direction
// walks t descending with the same mask. Batch 64 is eight clusters of 16
// blocks of 256 threads at 65 KB of shared memory each, so up to three
// blocks share an SM and all eight run at once. It replaced, for bf16, the
// one-block-per-row kernel below, which pulled all of U from L2 in each of
// 128 blocks every step and ran the product as FP32 FMAs. What bounds it
// now is the step's chain: the product's shared-memory reads, the cluster
// barrier and the 8 KB pull of h. On an H100 at 700 W a step takes ~2.8 us,
// of which tools/ablate_lstm_fwd.py puts ~0.7 in the product, ~0.7 in the
// cluster barrier, ~0.25 in the remote part of the pull and ~1.3 in the
// gate math, the stores and the block barriers. The launch checks
// cudaOccupancyMaxActiveClusters and fails where no cluster of the shape
// fits (the wrapper raises); it never degrades to another kernel. The
// wrapper hands both U as they are, so no call packs them with torch ops.
//
// f32 -- bilstm_fwd_kernel (f32 U is 1 MB a direction; a tensor-core
// product would be TF32): one block per (batch tile of NB rows, direction),
// H threads: thread k owns hidden unit k, computes its four gate columns
// k, H+k, 2H+k, 3H+k for the tile's rows, and keeps that unit's h and c in
// registers, so the gate math and the state update are thread-local. The
// tile's h sits in shared memory, with two __syncthreads per step. The
// wrapper hands U in a packed layout [H/VEC][4H][VEC] (VEC = 4 floats, 16
// bytes), so one 16-byte load per thread and gate brings VEC
// consecutive rows of U and a warp's loads cover 512 contiguous bytes; the
// loop over those loads is unrolled 4 deep to keep several in flight.
// NB = 1 spreads batch 64 over 128 blocks (both directions) of H = 256
// threads, which spreads the FMAs over nearly all 132 SMs, at the price of
// every block pulling all of U from L2 each step (a sweep over NB in
// {1, 2, 4, 8}, launch bounds and unrolling on an H100 chose these values
// for its first, bf16 version).
//
// The TPU carried h/c in VMEM scratch across a sequential grid; on the GPU
// blocks run in parallel and in no order, so the time loop lives inside the
// block.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/rnn_cuda.py). Each entry point launches on the
// given stream, does not synchronise, and returns a cudaError_t.

#include "lstm_common.cuh"
#include "lstm_fwd_cluster.cuh"

namespace {

using lstm_common::sigmoid_f32;

constexpr int kTileRows = 1;     // NB: batch rows per f32 block
constexpr int kMaxHidden = 256;  // H: threads per f32 block

// --- bf16: the cluster recurrence (lstm_fwd_cluster.cuh) -------------------

// Direction blockIdx.z: 0 forward (t ascending), 1 backward (descending).
__global__ void __launch_bounds__(lstm_fwd_cluster::kMaxThreads)
bilstm_fwd_cluster_kernel(
    const __nv_bfloat16* __restrict__ xpf,
    const __nv_bfloat16* __restrict__ xpb, long long x_row_stride,
    const __nv_bfloat16* __restrict__ uf,
    const __nv_bfloat16* __restrict__ ub, const __nv_bfloat16* __restrict__ bf,
    const __nv_bfloat16* __restrict__ bb, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ of, __nv_bfloat16* __restrict__ ob,
    __nv_bfloat16* __restrict__ gf, __nv_bfloat16* __restrict__ gb,
    __nv_bfloat16* __restrict__ hf, __nv_bfloat16* __restrict__ hb,
    __nv_bfloat16* __restrict__ cf, __nv_bfloat16* __restrict__ cb,
    int t_len, int n_rows, int hid, int units, float forget_bias) {
  const bool bw = blockIdx.z == 1;
  lstm_fwd_cluster::recurrence(bw ? xpb : xpf, x_row_stride, bw ? ub : uf,
                               bw ? bb : bf, lens, bw ? ob : of, bw ? gb : gf,
                               bw ? hb : hf, bw ? cb : cf, t_len, n_rows, hid,
                               units, forget_bias, bw);
}

// --- f32: one block per batch row and direction ----------------------------

template <int NB>
__global__ void __launch_bounds__(kMaxHidden)
bilstm_fwd_kernel(const float* __restrict__ xpf, const float* __restrict__ xpb,
                  long long x_row_stride,
                  const float* __restrict__ uf, const float* __restrict__ ub,
                  const float* __restrict__ bf, const float* __restrict__ bb,
                  const int* __restrict__ lens,
                  float* __restrict__ of, float* __restrict__ ob,
                  float* __restrict__ gf, float* __restrict__ gb,
                  float* __restrict__ hf, float* __restrict__ hb,
                  float* __restrict__ cf, float* __restrict__ cb,
                  int t_len, int n_rows, int hid, float forget_bias) {
  constexpr int VEC = 4;                         // floats per 16 bytes
  const int dir = blockIdx.y;                    // 0: forward, 1: backward
  const float* __restrict__ xp = dir ? xpb : xpf;
  const float* __restrict__ u = dir ? ub : uf;
  const float* __restrict__ bias = dir ? bb : bf;
  float* __restrict__ out = dir ? ob : of;
  float* __restrict__ g_out = dir ? gb : gf;
  float* __restrict__ h_out = dir ? hb : hf;
  float* __restrict__ c_out = dir ? cb : cf;
  const bool save = g_out != nullptr;

  const int k = threadIdx.x;                     // hidden unit
  const int n0 = blockIdx.x * NB;
  const int four_h = 4 * hid;

  extern __shared__ float h_tile[];              // [NB][hid]

  float h[NB], c[NB];
  int len[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    h[r] = 0.0f;
    c[r] = 0.0f;
    len[r] = (n0 + r < n_rows) ? lens[n0 + r] : 0;
    h_tile[r * hid + k] = 0.0f;
  }
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = bias[g * hid + k];
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = dir ? t_len - 1 - s : s;
    float acc[4][NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const int n = n0 + r;
      const float* x_row = xp + ((long long)t * n_rows + n) * x_row_stride;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g][r] = (n < n_rows) ? x_row[g * hid + k] : 0.0f;
    }

    // acc[g][r] += sum_kk h_tile[r][kk] * U[kk][g*hid + k]
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
        float uu[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) uu[g] = uv[g][v];
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          const float hv = h_tile[r * hid + kb * VEC + v];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hv, uu[g], acc[g][r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const int n = n0 + r;
      const float gi = sigmoid_f32(acc[0][r] + b[0]);
      const float gj = tanhf(acc[1][r] + b[1]);
      const float gfo = sigmoid_f32(acc[2][r] + b[2] + forget_bias);
      const float go = sigmoid_f32(acc[3][r] + b[3]);
      const float c_new = gfo * c[r] + gi * gj;
      const float h_new = go * tanhf(c_new);
      const bool live = len[r] > t;
      if (live) {
        h[r] = h_new;
        c[r] = c_new;
      }
      if (n < n_rows) {
        const long long row = (long long)t * n_rows + n;
        out[row * hid + k] = live ? h_new : 0.0f;
        if (save) {
          float* g_row = g_out + row * four_h;
          g_row[k] = gi;
          g_row[hid + k] = gj;
          g_row[2 * hid + k] = gfo;
          g_row[3 * hid + k] = go;
          h_out[row * hid + k] = h[r];
          c_out[row * hid + k] = c[r];
        }
      }
    }
    __syncthreads();                             // all reads of h_tile done
#pragma unroll
    for (int r = 0; r < NB; ++r)
      h_tile[r * hid + k] = h[r];
    __syncthreads();
  }
}

}  // namespace

// Dynamic shared memory of one bf16 cluster block at (H, units), in bytes
// (for reports).
extern "C" int bilstm_fwd_cluster_smem(int hid, int units) {
  return (int)lstm_fwd_cluster::smem_bytes(hid, units);
}

// How many clusters of the bf16 recurrence at (H, units) the card holds at
// once (cudaOccupancyMaxActiveClusters; for reports), or -cudaError_t.
extern "C" int bilstm_fwd_max_clusters(int hid, int units) {
  if (!lstm_fwd_cluster::shape_ok(hid, units))
    return -(int)cudaErrorInvalidValue;
  return lstm_fwd_cluster::max_active_clusters(bilstm_fwd_cluster_kernel,
                                               hid, units);
}

// xpf/xpb: [T, N, 4H] rows x_row_stride elements apart; uf/ub: U [H, 4H] as
// it is; bf/bb: [4H]; lens: [N] int32; of/ob: [T, N, H]. gf/gb ([T, N,
// 4H]), hf/hb and cf/cb ([T, N, H]) are null unless residuals are saved.
// units: hidden units a cluster block owns (a multiple of 8, ceil(H /
// units) <= 16). H a multiple of 8, <= 256. Returns a cudaError_t
// (cudaErrorInvalidConfiguration when no cluster of ceil(H / units) blocks
// fits on the card).
extern "C" int bilstm_fwd_bf16(const void* xpf, const void* xpb,
                               long long x_row_stride, const void* uf,
                               const void* ub, const void* bf, const void* bb,
                               const void* lens, void* of, void* ob, void* gf,
                               void* gb, void* hf, void* hb, void* cf,
                               void* cb, int t_len, int n_rows, int hid,
                               int units, float forget_bias, void* stream) {
  using bf16 = __nv_bfloat16;
  if (t_len <= 0 || n_rows <= 0 || hid > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  static int checked[2] = {-1, -1};
  return lstm_fwd_cluster::launch(
      bilstm_fwd_cluster_kernel, checked, hid, units, n_rows, 2,
      static_cast<cudaStream_t>(stream), static_cast<const bf16*>(xpf),
      static_cast<const bf16*>(xpb), x_row_stride,
      static_cast<const bf16*>(uf), static_cast<const bf16*>(ub),
      static_cast<const bf16*>(bf), static_cast<const bf16*>(bb),
      static_cast<const int*>(lens), static_cast<bf16*>(of),
      static_cast<bf16*>(ob), static_cast<bf16*>(gf), static_cast<bf16*>(gb),
      static_cast<bf16*>(hf), static_cast<bf16*>(hb), static_cast<bf16*>(cf),
      static_cast<bf16*>(cb), t_len, n_rows, hid, units, forget_bias);
}

// As bilstm_fwd_bf16 without units, with uf/ub: U packed as [H/4][4H][4].
// Returns a cudaError_t.
extern "C" int bilstm_fwd_f32(const void* xpf, const void* xpb,
                              long long x_row_stride, const void* uf,
                              const void* ub, const void* bf, const void* bb,
                              const void* lens, void* of, void* ob, void* gf,
                              void* gb, void* hf, void* hb, void* cf, void* cb,
                              int t_len, int n_rows, int hid,
                              float forget_bias, void* stream) {
  if (t_len <= 0 || n_rows <= 0 || hid <= 0 || hid > kMaxHidden || hid % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + kTileRows - 1) / kTileRows, 2);
  const size_t smem = sizeof(float) * kTileRows * hid;
  bilstm_fwd_kernel<kTileRows>
      <<<grid, hid, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(xpf), static_cast<const float*>(xpb),
          x_row_stride, static_cast<const float*>(uf),
          static_cast<const float*>(ub), static_cast<const float*>(bf),
          static_cast<const float*>(bb), static_cast<const int*>(lens),
          static_cast<float*>(of), static_cast<float*>(ob),
          static_cast<float*>(gf), static_cast<float*>(gb),
          static_cast<float*>(hf), static_cast<float*>(hb),
          static_cast<float*>(cf), static_cast<float*>(cb), t_len, n_rows,
          hid, forget_bias);
  return (int)cudaGetLastError();
}
