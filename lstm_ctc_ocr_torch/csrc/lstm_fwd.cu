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
// bf16 (the type both models train and decode in) up to H = 512 --
// lstm_fwd_cluster_kernel,
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
// f32 (the type of the tests and the gradient checks) at every H, and bf16
// past H = 512 -- lstm_fwd_wide_kernel, the wide recurrence of
// lstm_wide.cuh: one block a batch row, its threads walking the units (one
// a unit up to 1024), computing each unit's four gate columns k, H+k, 2H+k,
// 3H+k as FP32 FMAs (f32 U is 4 MB at H = 512, and a tensor-core product
// would be TF32). The wrapper hands U packed as [H/VEC][4H][VEC], so one
// 16-byte load per thread and gate brings VEC consecutive rows of U and a
// warp's loads cover 512 contiguous bytes; every block re-reads U from L2
// each step. Right, not fast. It took the place of the first f32 kernel, the
// same design with one thread a unit and H <= 512.
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
#include "lstm_wide.cuh"

namespace {


constexpr int kMaxClusterHidden = 512;   // H of the bf16 cluster recurrence

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

// --- f32, and bf16 past the cluster: lstm_wide.cuh -----------------------

template <typename T>
__global__ void __launch_bounds__(lstm_wide::kMaxThreads)
lstm_fwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ up,
                     const T* __restrict__ bias, const int* __restrict__ lens,
                     T* __restrict__ out, T* __restrict__ g_out,
                     T* __restrict__ h_out, T* __restrict__ c_out, int t_len,
                     int n_rows, int hid, float forget_bias) {
  const int n = blockIdx.x;
  lstm_wide::fwd_row<T>(xp, 4LL * hid, up, bias, lens[n], out, g_out, h_out,
                        c_out, t_len, n_rows, n, hid, forget_bias, false);
}

template <typename T>
int launch_wide(const void* xp, const void* up, const void* bias,
                const void* lens, void* out, void* g_out, void* h_out,
                void* c_out, int t_len, int n_rows, int hid, float forget_bias,
                void* stream) {
  if (t_len <= 0 || n_rows <= 0 || !lstm_wide::shape_ok<T>(hid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = lstm_wide::fwd_smem(hid);
  const cudaError_t err = lstm_wide::allow_smem(lstm_fwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_fwd_wide_kernel<T><<<n_rows, lstm_wide::threads(hid), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(up),
      static_cast<const T*>(bias), static_cast<const int*>(lens),
      static_cast<T*>(out), static_cast<T*>(g_out), static_cast<T*>(h_out),
      static_cast<T*>(c_out), t_len, n_rows, hid, forget_bias);
  return (int)cudaGetLastError();
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
  if (t_len <= 0 || n_rows <= 0 || hid > kMaxClusterHidden)
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

// The wide recurrence (lstm_wide.cuh): f32 at every H, bf16 past the
// cluster's 512. Arguments as lstm_fwd_bf16 without ub, with up: U packed
// as [H/VEC][4H][VEC] (VEC = 8 in bf16, 4 in f32); H a multiple of VEC,
// <= 8192. Returns a cudaError_t.
extern "C" int lstm_fwd_wide_bf16(const void* xp, const void* up,
                                  const void* bias, const void* lens,
                                  void* out, void* g_out, void* h_out,
                                  void* c_out, int t_len, int n_rows, int hid,
                                  float forget_bias, void* stream) {
  return launch_wide<__nv_bfloat16>(xp, up, bias, lens, out, g_out, h_out,
                                    c_out, t_len, n_rows, hid, forget_bias,
                                    stream);
}

extern "C" int lstm_fwd_wide_f32(const void* xp, const void* up,
                                 const void* bias, const void* lens,
                                 void* out, void* g_out, void* h_out,
                                 void* c_out, int t_len, int n_rows, int hid,
                                 float forget_bias, void* stream) {
  return launch_wide<float>(xp, up, bias, lens, out, g_out, h_out, c_out,
                            t_len, n_rows, hid, forget_bias, stream);
}
