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
// bf16 (the type both models train and decode in) up to H = 512 --
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
// f32 (the type of the tests and the gradient checks) at every H, and bf16
// past H = 512 -- bilstm_fwd_wide_kernel, the wide recurrence of
// lstm_wide.cuh: one block a batch row and direction, its threads walking
// the units (one a unit up to 1024), U packed [H/VEC][4H][VEC] by the
// wrapper and streamed from L2 every step, the product as FP32 FMAs (f32
// U is 1 MB a direction at H = 256, and a tensor-core product would be
// TF32). Right, not fast: every block reads all of U every step. It took
// the place of the first f32 kernel, the same design with one thread a
// unit and H <= 256.
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
#include "lstm_wide.cuh"

namespace {


constexpr int kMaxClusterHidden = 512;   // H of the bf16 cluster recurrence

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

// --- f32, and bf16 past the cluster: lstm_wide.cuh -----------------------

// Batch row blockIdx.x, direction blockIdx.y (0 forward, 1 backward).
template <typename T>
__global__ void __launch_bounds__(lstm_wide::kMaxThreads)
bilstm_fwd_wide_kernel(const T* __restrict__ xpf, const T* __restrict__ xpb,
                       long long x_row_stride, const T* __restrict__ upf,
                       const T* __restrict__ upb, const T* __restrict__ bf,
                       const T* __restrict__ bb, const int* __restrict__ lens,
                       T* __restrict__ of, T* __restrict__ ob,
                       T* __restrict__ gf, T* __restrict__ gb,
                       T* __restrict__ hf, T* __restrict__ hb,
                       T* __restrict__ cf, T* __restrict__ cb, int t_len,
                       int n_rows, int hid, float forget_bias) {
  const int n = blockIdx.x;
  const bool bw = blockIdx.y == 1;
  lstm_wide::fwd_row<T>(bw ? xpb : xpf, x_row_stride, bw ? upb : upf,
                        bw ? bb : bf, lens[n], bw ? ob : of, bw ? gb : gf,
                        bw ? hb : hf, bw ? cb : cf, t_len, n_rows, n, hid,
                        forget_bias, bw);
}

template <typename T>
int launch_wide(const void* xpf, const void* xpb, long long x_row_stride,
                const void* upf, const void* upb, const void* bf,
                const void* bb, const void* lens, void* of, void* ob,
                void* gf, void* gb, void* hf, void* hb, void* cf, void* cb,
                int t_len, int n_rows, int hid, float forget_bias,
                void* stream) {
  if (t_len <= 0 || n_rows <= 0 || !lstm_wide::shape_ok<T>(hid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = lstm_wide::fwd_smem(hid);
  const cudaError_t err = lstm_wide::allow_smem(bilstm_fwd_wide_kernel<T>,
                                                smem);
  if (err != cudaSuccess) return (int)err;
  bilstm_fwd_wide_kernel<T><<<dim3(n_rows, 2), lstm_wide::threads(hid), smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xpf), static_cast<const T*>(xpb), x_row_stride,
      static_cast<const T*>(upf), static_cast<const T*>(upb),
      static_cast<const T*>(bf), static_cast<const T*>(bb),
      static_cast<const int*>(lens), static_cast<T*>(of), static_cast<T*>(ob),
      static_cast<T*>(gf), static_cast<T*>(gb), static_cast<T*>(hf),
      static_cast<T*>(hb), static_cast<T*>(cf), static_cast<T*>(cb), t_len,
      n_rows, hid, forget_bias);
  return (int)cudaGetLastError();
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
// units) <= 16). H a multiple of 8, <= 512. Returns a cudaError_t
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
  if (t_len <= 0 || n_rows <= 0 || hid > kMaxClusterHidden)
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

// The wide recurrence (lstm_wide.cuh): f32 at every H, bf16 past the
// cluster's 512. Arguments as bilstm_fwd_bf16 without units, with upf/upb:
// U packed as [H/VEC][4H][VEC] (VEC = 8 in bf16, 4 in f32); H a multiple of
// VEC, <= 8192. Returns a cudaError_t.
extern "C" int bilstm_fwd_wide_bf16(const void* xpf, const void* xpb,
                                    long long x_row_stride, const void* upf,
                                    const void* upb, const void* bf,
                                    const void* bb, const void* lens, void* of,
                                    void* ob, void* gf, void* gb, void* hf,
                                    void* hb, void* cf, void* cb, int t_len,
                                    int n_rows, int hid, float forget_bias,
                                    void* stream) {
  return launch_wide<__nv_bfloat16>(xpf, xpb, x_row_stride, upf, upb, bf, bb,
                                    lens, of, ob, gf, gb, hf, hb, cf, cb,
                                    t_len, n_rows, hid, forget_bias, stream);
}

extern "C" int bilstm_fwd_wide_f32(const void* xpf, const void* xpb,
                                   long long x_row_stride, const void* upf,
                                   const void* upb, const void* bf,
                                   const void* bb, const void* lens, void* of,
                                   void* ob, void* gf, void* gb, void* hf,
                                   void* hb, void* cf, void* cb, int t_len,
                                   int n_rows, int hid, float forget_bias,
                                   void* stream) {
  return launch_wide<float>(xpf, xpb, x_row_stride, upf, upb, bf, bb, lens,
                            of, ob, gf, gb, hf, hb, cf, cb, t_len, n_rows,
                            hid, forget_bias, stream);
}
