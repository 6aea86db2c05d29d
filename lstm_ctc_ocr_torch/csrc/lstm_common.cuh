// Pieces shared by the port's kernels (lstm_fwd.cu, lstm_bwd.cu,
// bilstm_fwd.cu, bilstm_bwd.cu, conv_bn.cu, ctc.cu): conversions between
// the element type and f32, the sigmoid, the tensor-core building blocks
// (cp.async 16-byte copies that zero-fill, ldmatrix, mma.sync m16n8k16
// bf16 -> f32), the thread-block cluster launch of the bf16 recurrences
// (lstm_fwd_cluster.cuh, lstm_bwd_cluster.cuh), and the two reductions
// every LSTM backward ends with: dU = h_prev^T dx as a shared-memory tiled
// product (FP32 FMAs, or tensor cores for bf16) and db as an ordered sum of
// per-row partials. All are deterministic: fixed summation order, no
// atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_common {

constexpr int kTile = 64;         // dU output tile edge
constexpr int kTileRows = 16;     // dU rows of (t, n) per tile step

// --- tensor-core building blocks (sm_80 and later; built for sm_90a) -------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; with valid false nothing is
// read (src-size 0) and the 16 bytes are zero-filled by the copy itself.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b for one m16n8k16 tile: a row-major (4 regs), b column-major
// (2 regs), bf16 inputs, f32 accumulators. d[0..1]: row lane/4, columns
// 2 (lane%4) + {0, 1}; d[2..3]: row lane/4 + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One 64x64 tile of du[k][m] = sum_{r < n_k} a[r][k] * b[r][m], with
// a: [n_k, hid] and b: [n_k, four_h], f32 accumulators. Called by a block of
// 256 threads (16 x 16, 4 x 4 outputs each); the tile is (k0, m0).
template <typename T>
__device__ __forceinline__ void du_tile(const T* __restrict__ a,
                                        const T* __restrict__ b,
                                        float* __restrict__ du, long long n_k,
                                        int hid, int four_h, int k0, int m0) {
  __shared__ float a_s[kTileRows][kTile];
  __shared__ float b_s[kTileRows][kTile];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lr = tid / 16, lc = (tid % 16) * 4;  // this thread's load cell

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (long long r0 = 0; r0 < n_k; r0 += kTileRows) {
    const long long r = r0 + lr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + lc + e, mm = m0 + lc + e;
      a_s[lr][lc + e] = (r < n_k && kk < hid) ? to_f32(a[r * hid + kk]) : 0.0f;
      b_s[lr][lc + e] =
          (r < n_k && mm < four_h) ? to_f32(b[r * four_h + mm]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kTileRows; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mm = m0 + tx * 4 + j;
      if (kk < hid && mm < four_h) du[(long long)kk * four_h + mm] = acc[i][j];
    }
  }
}

// The tensor-core form of du_tile for bf16 (lstm_bwd.cu): one 64x64 tile of
// du[k][m] = sum_{r < n_k} a[r][k] * b[r][m] with mma.sync, f32
// accumulators. Called by a block of kDuThreads threads (4 warps, 2 x 2,
// 32 x 32 outputs each); hid and four_h are multiples of 8. Rows of (t, n)
// come in steps of kDuRows through a kDuStages-deep ring of cp.async
// copies (rows past n_k and columns past hid / four_h zero-filled by the
// copy); both operands sit in shared memory as [row][column] and reach the
// mma through ldmatrix.trans. Every block walks all n_k rows in ascending
// order: no split-K, no atomics.
constexpr int kDuThreads = 128;
constexpr int kDuRows = 32;                 // rows (t, n) per stage
constexpr int kDuStages = 3;
constexpr int kDuPitch = kTile + 8;         // bf16 per smem row (144 bytes)

__device__ __forceinline__ void du_mma_tile(const __nv_bfloat16* __restrict__ a,
                                            const __nv_bfloat16* __restrict__ b,
                                            float* __restrict__ du,
                                            long long n_k, int hid, int four_h,
                                            int k0, int m0) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kDuStages][kDuRows][kDuPitch];
  __shared__ __align__(16) __nv_bfloat16 b_s[kDuStages][kDuRows][kDuPitch];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wk = (warp / 2) * 32, wm = (warp % 2) * 32;   // warp's outputs
  const int steps = (int)((n_k + kDuRows - 1) / kDuRows);

  auto load = [&](int stage, int step) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {           // 256 chunks of 16 bytes each
      const int idx = tid + e * kDuThreads;
      const int rr = idx / 8, cc = (idx % 8) * 8;
      const long long r = (long long)step * kDuRows + rr;
      const bool ok_a = r < n_k && k0 + cc < hid;
      const bool ok_b = r < n_k && m0 + cc < four_h;
      cp_async16(smem_addr(&a_s[stage][rr][cc]),
                 ok_a ? a + r * hid + k0 + cc : a, ok_a);
      cp_async16(smem_addr(&b_s[stage][rr][cc]),
                 ok_b ? b + r * four_h + m0 + cc : b, ok_b);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kDuStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  const int mi = lane / 8, mj = lane % 8;   // ldmatrix: matrix, row in it
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kDuStages - 2>();
    __syncthreads();
    const int next = s + kDuStages - 1;
    if (next < steps) load(next % kDuStages, next);
    cp_async_commit();
    const int st = s % kDuStages;
#pragma unroll
    for (int kk = 0; kk < kDuRows; kk += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)     // A = a^T: rows k of du, depth r
        ldmatrix_x4_trans(af[i], smem_addr(&a_s[st][kk + (mi / 2) * 8 + mj]
                                                [wk + i * 16 + (mi % 2) * 8]));
#pragma unroll
      for (int j = 0; j < 2; ++j)     // B = b: depth r, columns m
        ldmatrix_x4_trans(bf[j], smem_addr(&b_s[st][kk + (mi % 2) * 8 + mj]
                                                [wm + j * 16 + (mi / 2) * 8]));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                   bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kk = k0 + wk + i * 16 + lane / 4 + half * 8;
      if (kk >= hid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = m0 + wm + j * 8 + (lane % 4) * 2;
        if (mm < four_h)        // four_h is a multiple of 8: mm + 1 too
          *reinterpret_cast<float2*>(du + (long long)kk * four_h + mm) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
}

// --- thread-block cluster launches (the bf16 LSTM recurrences) -------------

// The launch configuration of a cluster recurrence: clusters of `cs` blocks
// of `threads` threads along x, one cluster per 16-row group along y,
// `dirs` directions along z (a cluster never spans two), `smem` bytes of
// dynamic shared memory a block.
inline void cluster_config(int cs, int threads, size_t smem, int n_groups,
                           int dirs, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cs, n_groups, dirs);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Sets `kernel`'s attributes for one cluster shape (its shared memory, and
// the non-portable size above 8 blocks) and returns how many such clusters
// the card holds at once, or -cudaError_t.
template <typename Kernel>
int cluster_max_active(Kernel kernel, int cs, int threads, size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cs, threads, smem, 1, 1, nullptr, &cfg, &attr);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Checks once per (kernel, H, UB) -- the caller keeps `checked` -- that a
// cluster of this shape fits the card, then launches `kernel` with `args`
// on `n_groups` row groups and `dirs` directions. Fails, never degrades:
// cudaErrorInvalidConfiguration when no cluster fits.
template <typename Kernel, typename... Args>
int cluster_launch(Kernel kernel, int (&checked)[2], int hid, int ub,
                   int cs, int threads, size_t smem, int n_groups, int dirs,
                   cudaStream_t stream, Args... args) {
  if (checked[0] != hid || checked[1] != ub) {
    const int clusters = cluster_max_active(kernel, cs, threads, smem);
    if (clusters < 0) return -clusters;
    if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
    checked[0] = hid;
    checked[1] = ub;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cs, threads, smem, n_groups, dirs, stream, &cfg, &attr);
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// db[m] = sum over n (ascending) of part[n][m]; part: [n_rows, four_h].
__device__ __forceinline__ void db_sum(const float* __restrict__ part,
                                       float* __restrict__ db, int n_rows,
                                       int four_h) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= four_h) return;
  float sum = 0.0f;
  for (int n = 0; n < n_rows; ++n) sum += part[(long long)n * four_h + m];
  db[m] = sum;
}

}  // namespace lstm_common
