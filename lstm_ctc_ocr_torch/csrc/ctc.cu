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
// on lanes and kept alpha in VMEM scratch across a fori_loop. Here one block
// of S rounded up to a warp multiple (32..1024 threads) owns one example:
// thread s keeps alpha[s] (beta[s]) in a register for the whole time loop,
// and the s-1, s-2 (s+1, s+2) neighbours come from a double-buffered
// shared-memory row with two NEG pad cells, one __syncthreads per step. The
// next step's g is loaded before the current step's math so the load is off
// the dependent chain. Threads past S carry NEG and write nothing. The
// batch needs no padding. A block holds at most 1024 threads, so S <= 1023:
// labels of up to 511 characters, where the TPU kernel's one 128-lane row
// stopped at 63.
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes
// (lstm_ctc_ocr_torch/ops/ctc_cuda.py). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;  // one thread per state, S <= 1023
constexpr int kMaxStates = kMaxThreads - 1;   // labels up to 511 characters

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m > 0.5f * kNeg ? out : kNeg;
}

__global__ void __launch_bounds__(kMaxThreads)
ctc_fwd_kernel(const float* __restrict__ g, const float* __restrict__ skip,
               const float* __restrict__ valid, const float* __restrict__ fin,
               float* __restrict__ logz, float* __restrict__ alphas,
               int t_len, int s_len) {
  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int width = blockDim.x + 2;              // two pad cells in front
  const bool active = s < s_len;
  extern __shared__ float row[];                 // [2][width]
  if (s < 2) {
    row[s] = kNeg;
    row[width + s] = kNeg;
  }
  const float sk = active ? skip[(long long)n * s_len + s] : kNeg;
  const float va = active ? valid[(long long)n * s_len + s] : kNeg;
  const float fi = active ? fin[(long long)n * s_len + s] : kNeg;
  const float* gn = g + (long long)n * t_len * s_len;
  float* an = alphas + (long long)n * t_len * s_len;

  const float g0 = active ? gn[s] : kNeg;
  float alpha = (s <= 1 ? g0 : kNeg) + va;
  if (active) an[s] = alpha;
  float g_next = (active && t_len > 1) ? gn[s_len + s] : kNeg;
  for (int t = 1; t < t_len; ++t) {
    const float gt = g_next;
    if (active && t + 1 < t_len) g_next = gn[(long long)(t + 1) * s_len + s];
    float* buf = row + (t & 1) * width;
    buf[s + 2] = alpha;
    __syncthreads();
    const float one = buf[s + 1];
    const float two = buf[s] + sk;
    alpha = fmaxf(gt + lse3(alpha, one, two) + va, kNeg);
    if (active) an[(long long)t * s_len + s] = alpha;
  }

  // logz over the final states: final is 0 on at most two states and NEG on
  // the rest, whose terms exp(. - ms) are exactly 0, so the first warp's
  // threads each sum a strided share of the row and thread 0 adds the 32
  __syncthreads();
  row[s] = alpha + fi;
  __syncthreads();
  if (s < 32) {
    float m = kNeg;
    for (int i = s; i < s_len; i += 32) m = fmaxf(m, row[i]);
    for (int d = 16; d > 0; d >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    const float ms = fmaxf(m, kNeg);
    float sum = 0.0f;
    for (int i = s; i < s_len; i += 32) sum += expf(row[i] - ms);
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    if (s == 0) logz[n] = m > 0.5f * kNeg ? ms + logf(sum) : kNeg;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
ctc_bwd_kernel(const float* __restrict__ g, const float* __restrict__ skip,
               const float* __restrict__ valid, const float* __restrict__ fin,
               const float* __restrict__ alphas,
               const float* __restrict__ logz, const int* __restrict__ lens,
               float* __restrict__ grad, int t_len, int s_len) {
  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int width = blockDim.x + 2;              // two pad cells at the end
  const bool active = s < s_len;
  extern __shared__ float row[];                 // [2][width]
  if (s < 2) {
    row[blockDim.x + s] = kNeg;
    row[width + blockDim.x + s] = kNeg;
  }
  // additive mask at source s for the s -> s+2 hop: skip[s+2]
  const float sk_fwd =
      (s + 2 < s_len) ? skip[(long long)n * s_len + s + 2] : kNeg;
  const float va = active ? valid[(long long)n * s_len + s] : kNeg;
  const float fi = active ? fin[(long long)n * s_len + s] : kNeg;
  const float lz = logz[n];
  const float feasible = lz > 0.5f * kNeg ? 1.0f : 0.0f;
  const int len = lens[n];
  const float* gn = g + (long long)n * t_len * s_len;
  const float* an = alphas + (long long)n * t_len * s_len;
  float* dn = grad + (long long)n * t_len * s_len;

  float gt = active ? gn[(long long)(t_len - 1) * s_len + s] : kNeg;
  float at = active ? an[(long long)(t_len - 1) * s_len + s] : kNeg;
  float beta = fmaxf(gt + fi + va, kNeg);
  for (int t = t_len - 1; t >= 0; --t) {
    if (t < t_len - 1) {
      float* buf = row + (t & 1) * width;
      buf[s] = beta;
      __syncthreads();
      const float one = buf[s + 1];
      const float two = buf[s + 2] + sk_fwd;
      beta = fmaxf(gt + lse3(beta, one, two) + va, kNeg);
    }
    const float g_cur = gt;
    const float a_cur = at;
    if (active && t > 0) {                       // next step's loads
      gt = gn[(long long)(t - 1) * s_len + s];
      at = an[(long long)(t - 1) * s_len + s];
    }
    if (active) {
      const float lg = a_cur + beta - g_cur - lz;
      const float post = lg > 0.5f * kNeg ? expf(fminf(lg, 0.0f)) : 0.0f;
      const float live = t < len ? 1.0f : 0.0f;
      dn[(long long)t * s_len + s] = -post * feasible * live;
    }
  }
}

int block_threads(int s_len) { return ((s_len + 31) / 32) * 32; }

}  // namespace

// g, alphas: [N, T, S] f32; skip, valid, fin: [N, S] f32 additive masks;
// logz: [N] f32. Returns a cudaError_t.
extern "C" int ctc_fwd(const void* g, const void* skip, const void* valid,
                       const void* fin, void* logz, void* alphas, int n_rows,
                       int t_len, int s_len, void* stream) {
  if (n_rows <= 0 || t_len <= 0 || s_len <= 0 || s_len > kMaxStates)
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads(s_len);
  const size_t smem = sizeof(float) * 2 * (threads + 2);
  ctc_fwd_kernel<<<n_rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(skip),
      static_cast<const float*>(valid), static_cast<const float*>(fin),
      static_cast<float*>(logz), static_cast<float*>(alphas), t_len, s_len);
  return (int)cudaGetLastError();
}

// As ctc_fwd, plus lens: [N] int32 and grad: [N, T, S] f32 (output).
extern "C" int ctc_bwd(const void* g, const void* skip, const void* valid,
                       const void* fin, const void* alphas, const void* logz,
                       const void* lens, void* grad, int n_rows, int t_len,
                       int s_len, void* stream) {
  if (n_rows <= 0 || t_len <= 0 || s_len <= 0 || s_len > kMaxStates)
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads(s_len);
  const size_t smem = sizeof(float) * 2 * (threads + 2);
  ctc_bwd_kernel<<<n_rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(skip),
      static_cast<const float*>(valid), static_cast<const float*>(fin),
      static_cast<const float*>(alphas), static_cast<const float*>(logz),
      static_cast<const int*>(lens), static_cast<float*>(grad), t_len, s_len);
  return (int)cudaGetLastError();
}
