// CTC prefix beam search for Hopper (sm_90a): one kernel per decode call.
//
// Replaces no TPU kernel: the JAX package's ops/beam.py is XLA, a scan over
// frames of about a hundred small array ops a frame. Its plain PyTorch
// counterpart, lstm_ctc_ocr_torch/ops/beam.py:beam_decode_reference, ran the
// same ops as a Python loop on the card, about 100 launches a frame. This
// kernel computes that function -- the same candidates, scores, merges, tie
// rule and output -- with the whole frame loop inside one launch.
//
// What bounds it on an H100: a chain of T dependent frames per row. A row
// reads its T x C logits once (1.8 MB for a 64-line longline request) and
// does about K (C + 1) candidate scores a frame; neither bytes nor FLOPs
// come near the card's limits. The time is the latency of each frame's
// few dependent phases, so the design keeps everything a frame touches in
// shared memory and spends its effort on the number of block barriers a
// frame needs (five, where the candidates' list is short).
//
// Design: one block of kThreads threads per batch row (rows are
// independent; a request of N rows runs N blocks at once). Per frame:
//   1. log-softmax of the frame's C logits, computed kWarps frames ahead (one
//      warp a frame) into a ring in shared memory. Each warp uses the layout
//      and operation order of torch's softmax_warp_forward (the kernel
//      torch.log_softmax runs on the card for rows of up to 1,024 classes):
//      P = C rounded up to a power of two, W = min(P, 32) lanes, lane l owns
//      classes l, l + W, ...; max then sum of expf(x - max) in that order,
//      each followed by a butterfly over the W lanes; (x - max) - logf(sum).
//      So the log-probabilities are the plain version's, bit for bit.
//   2. per beam (K threads): total = lse(p_b, p_nb), the stay candidate's
//      blank and repeat masses.
//   3. the K*C extend candidates (all threads), and the K^2 pairs (i, j)
//      where the stay of beam i collides with the extend (j, last_i), that
//      is plen_i == plen_j + 1 and P_j == P_i[:-1]. A pair is tested only
//      where a 32-bit hash of P_i[:-1] equals that of P_j; every merge is
//      then confirmed by comparing the two prefixes character by character
//      (below), so no merge rests on a hash.
//   4. per beam: the colliding extend's mass is merged into the stay (the
//      plain version's masked logsumexp) and the extend is killed.
//   5. the K best of the K + K*C candidates in the order (score descending,
//      candidate index ascending) -- the plain version's stable sort, and
//      jax.lax.top_k's tie rule -- compared as one 48-bit key (the
//      order-preserving bits of the f32 score, then 0xFFFF minus the index).
//      The K stays alone hold K keys at or above the least of theirs, so
//      only candidates at or above it can be chosen: they are listed (a
//      ballot a warp), and where the list fits the block each one's rank
//      among them is counted. A longer list falls back to a block-wide radix
//      select over all candidates, 8 bits a pass, stopping at the first pass
//      whose bin holds exactly the candidates still needed, and the K chosen
//      are ranked the same way. Beam slot = rank.
// Prefixes live in a trie in shared memory: node 0 is the empty prefix and
// every selected extend of frame t gets node 1 + t*K + rank, holding its
// parent node and its character (16 bits each). A beam holds its node, so
// a stay copies nothing and an extend writes one word. Two prefixes of
// equal length are compared by walking both parent chains until the nodes
// meet (equal from there on) or two characters differ. The best beam's
// prefix is read back along its chain at the end, and merge_repeated is
// applied then, in the kernel.
//
// Exactness: all f32 arithmetic is the plain version's formula in its
// order (the _lse guards against NEG, the NEG/2 test, expf/logf, no
// fast-math; no product is there to be contracted into an FMA). Dead beams
// -- the K-1 that start dead, with their unique negative first characters
// and length T, and what the pruning keeps of them while fewer than K
// candidates live -- only ever hold NEG and never collide with a live
// prefix, so the kernel marks them by a negative node and leaves them out
// of the pair test, which changes no score. (Pruning fills slots beyond
// the live candidates with the lowest-indexed NEG candidates, which are
// always such dead stays, so no other beam is ever dead.) A row stops at
// its own length; the plain version's masking keeps the state past it,
// which is the same.
//
// Limits, raised by the wrapper (lstm_ctc_ocr_torch/ops/beam_cuda.py) and
// checked again here: C <= kMaxClasses (torch's one-warp log-softmax
// layout), K <= kThreads, K (C + 1) <= kMaxCandidates (16-bit candidate
// index in the key), T*K < 65536 (16-bit node links), and the shared
// memory of layout() <= 227 KB (at K = 16, C = 64 that is T up to ~3,400).
//
// Built with nvcc into a shared library with a plain C interface
// (lstm_ctc_ocr_torch/ops/_build.py) and bound with ctypes. The entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;    // frames a log-softmax refill holds
constexpr int kMaxClasses = 1024;
constexpr int kMaxCandidates = 16384;
constexpr int kMaxNodes = 65536;         // node ids and links are 16 bits
constexpr int kMaxShared = 232448;       // an H100 block's shared memory
constexpr unsigned kHashSeed = 2166136261u;
constexpr unsigned kHashMul = 16777619u;
static_assert(kThreads == 256, "a thread a radix bin: hist[tid] = 0");

struct Beam {
  float pb, pnb;          // log mass ending in blank / in a non-blank
  int plen, last, node;   // prefix length, last character (-1: none), trie
                          // node (a dead beam: its first character, < 0)
  unsigned hpar, hfull;   // hashes of the prefix less its last character,
                          // and of the whole prefix
};
static_assert(sizeof(Beam) == 28,
              "ops/beam_cuda.py:shared_bytes counts a Beam as 28 bytes");

// Byte offsets of the shared-memory sections; ops/beam_cuda.py's
// shared_bytes() mirrors the total, and ctc_beam_shared_bytes() below
// returns it so that a test on the card holds the two together.
struct Layout {
  int cand, ring, beams, frame, hist, list, ctrl, out, arena, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int t_len, int k, int c) {
  Layout l;
  int o = 0;
  l.cand = o;  o += align16(4 * k * (c + 1));      // candidate scores
  l.ring = o;  o += align16(4 * kWarps * c);       // log-probabilities
  l.beams = o; o += align16(2 * k * (int)sizeof(Beam));
  l.frame = o; o += align16(4 * 4 * k);  // total, pb/pnb of stays, partner
  l.hist = o;  o += align16(2 * 256 * 4);          // two radix histograms
  l.list = o;  o += align16(8 * kThreads);         // listed candidates
  l.ctrl = o;  o += align16(32);                   // select state, counters
  l.out = o;   o += align16(2 * t_len);            // the best prefix
  l.arena = o; o += align16(4 * (1 + t_len * k));  // trie nodes
  l.bytes = o;
  return l;
}

// The plain version's _lse(a, b).
__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms));
  return m > kNeg * 0.5f ? out : kNeg;
}

// Larger key, better candidate: f32 order, then the lower index.
__device__ __forceinline__ unsigned long long cand_key(float s, int e) {
  const unsigned u = __float_as_uint(s);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 16) | (unsigned)(0xFFFF - e);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One frame's log-softmax by one warp, in torch's softmax_warp_forward
// layout and order (see the header). dst receives the C values.
template <typename In>
__device__ void log_softmax_row(const In* __restrict__ x, float* dst, int c,
                                int lane) {
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  const int w = p2 < 32 ? p2 : 32;
  const int iters = p2 / w;
  const bool own = lane < w;
  float mx = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int idx = lane + it * w;
    const bool in = own && idx < c;
    const float v = in ? to_f32(x[idx]) : -INFINITY;
    if (in) dst[idx] = v;
    mx = it == 0 ? v : (mx > v ? mx : v);
  }
  for (int off = w / 2; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, mx, off, w);
    mx = mx < o ? o : mx;
  }
  float sum = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int idx = lane + it * w;
    const float v = (own && idx < c) ? dst[idx] : -INFINITY;
    sum += expf(v - mx);
  }
  for (int off = w / 2; off > 0; off /= 2)
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, off, w);
  const float ls = logf(sum);
  for (int it = 0; it < iters; ++it) {
    const int idx = lane + it * w;
    if (own && idx < c) dst[idx] = (dst[idx] - mx) - ls;
  }
}

// Whether the stay of beam i collides with an extend of beam j: P_j ==
// P_i[:-1]. Live beams only. The hash rules out most unequal pairs; the
// walk decides.
__device__ __forceinline__ bool collides(const Beam& bi, const Beam& bj,
                                         const unsigned* arena) {
  if (bi.node < 0 || bj.node < 0 || bi.plen != bj.plen + 1 || bi.last < 0 ||
      bi.hpar != bj.hfull)
    return false;
  int x = (int)(arena[bi.node] >> 16), y = bj.node;
  while (x != y) {
    const unsigned ax = arena[x], ay = arena[y];
    if ((ax & 0xFFFFu) != (ay & 0xFFFFu)) return false;
    x = (int)(ax >> 16);
    y = (int)(ay >> 16);
  }
  return true;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    beam_kernel(const In* __restrict__ logits, long long stride_n,
                long long stride_t, const int* __restrict__ lens,
                int* __restrict__ out, int t_len, int k, int c, int blank,
                int merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(t_len, k, c);
  float* cand = reinterpret_cast<float*>(smem + L.cand);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  Beam* beams = reinterpret_cast<Beam*>(smem + L.beams);
  float* total = reinterpret_cast<float*>(smem + L.frame);
  float* pb_stay = total + k;
  float* pnb_stay = pb_stay + k;
  int* partner = reinterpret_cast<int*>(pnb_stay + k);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist);
  unsigned long long* flist =
      reinterpret_cast<unsigned long long*>(smem + L.list);
  unsigned long long* sel_prefix =
      reinterpret_cast<unsigned long long*>(smem + L.ctrl);
  int* ctrl = reinterpret_cast<int*>(smem + L.ctrl + 8);
  short* obuf = reinterpret_cast<short*>(smem + L.out);
  unsigned* arena = reinterpret_cast<unsigned*>(smem + L.arena);
  // ctrl: [0] candidates still needed, [1] select done, [2] listed
  // candidates, [3] output length, [4] chosen by the radix select

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cand = k * (c + 1);
  const int row = blockIdx.x;
  const In* x = logits + row * stride_n;
  const int len = min(max(lens[row], 0), t_len);

  // Beam 0 holds the empty prefix; beams 1..K-1 start dead, with the first
  // characters -(index + 1) and length T.
  if (tid < k) {
    Beam b;
    b.pb = tid == 0 ? 0.f : kNeg;
    b.pnb = kNeg;
    b.plen = tid == 0 ? 0 : t_len;
    b.last = -1;
    b.node = tid == 0 ? 0 : -(tid + 1);
    b.hpar = 0;
    b.hfull = kHashSeed;
    beams[tid] = b;
  }
  if (tid == 0) arena[0] = 0;
  int cur = 0;
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    if (t % kWarps == 0) {
      if (t + warp < len)
        log_softmax_row(x + (t + warp) * stride_t, ring + warp * c, c, lane);
      __syncthreads();
    }
    const float* y = ring + (t % kWarps) * c;
    const Beam* old = beams + cur * k;
    Beam* nxt = beams + (cur ^ 1) * k;

    if (tid < k) {
      const Beam b = old[tid];
      const float tot = lse(b.pb, b.pnb);
      total[tid] = tot;
      pb_stay[tid] = tot + y[blank];
      pnb_stay[tid] = b.pnb + (b.last >= 0 ? y[b.last] : kNeg);
      partner[tid] = -1;
    }
    hist[tid] = 0;  // kThreads == 256: the first pass's histogram
    if (tid == 0) ctrl[2] = ctrl[4] = 0;
    __syncthreads();

    for (int e = tid; e < k * c; e += kThreads) {
      const int j = e / c, ch = e - j * c;
      float s = kNeg;
      if (ch != blank) s = (ch == old[j].last ? old[j].pb : total[j]) + y[ch];
      cand[k + e] = s;
    }
    // live prefixes are pairwise distinct, so a stay collides with at most
    // one extend, and no two stays with the same one
    for (int p = tid; p < k * k; p += kThreads)
      if (collides(old[p / k], old[p % k], arena)) partner[p / k] = p % k;
    __syncthreads();

    if (tid < k) {
      // the plain version's _row_lse over the colliding extends: one live
      // term v among NEG ones, so v + log(exp(v - v) + 0 + ... + 0); then
      // the kill
      const int i = tid, j = partner[i];
      float extra = kNeg;
      if (j >= 0) {
        const float v = cand[k + j * c + old[i].last];
        const float ms = fmaxf(v, kNeg);
        if (v > kNeg * 0.5f) extra = ms + logf(expf(v - ms));
        cand[k + j * c + old[i].last] = kNeg;
      }
      const float pnbs = lse(pnb_stay[i], extra);
      pnb_stay[i] = pnbs;
      cand[i] = lse(pb_stay[i], pnbs);
    }
    __syncthreads();

    // the K largest keys. The K stays alone hold K keys >= kappa, the least
    // of theirs, so only candidates at or above kappa can be chosen; their
    // list is usually short (dead stays rank below every live candidate)
    unsigned long long kappa = cand_key(cand[0], 0);
    for (int i = 1; i < k; ++i) {
      const unsigned long long q = cand_key(cand[i], i);
      kappa = q < kappa ? q : kappa;
    }
    for (int base = 0; base < n_cand; base += kThreads) {
      const int e = base + tid;
      const unsigned long long key = e < n_cand ? cand_key(cand[e], e) : 0ull;
      const bool in = e < n_cand && key >= kappa;
      const unsigned ballot = __ballot_sync(0xffffffffu, in);
      int at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&ctrl[2], __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
      if (in && at < kThreads) flist[at] = key;
    }
    __syncthreads();
    int m = ctrl[2];
    if (m > kThreads) {
      // too many: a radix select over all candidates, 8 bits a pass from the
      // top, stopping at the pass whose bin holds exactly those still needed
      unsigned long long prefix = 0;
      int needed = k, shift = 48, buf = 0;
      for (;;) {
        shift -= 8;
        unsigned* h = hist + buf * 256;
        hist[(buf ^ 1) * 256 + tid] = 0;  // the next pass's histogram
        for (int e = tid; e < n_cand; e += kThreads) {
          const unsigned long long key = cand_key(cand[e], e);
          if ((key >> (shift + 8)) == prefix)
            atomicAdd(&h[(unsigned)(key >> shift) & 255u], 1u);
        }
        __syncthreads();
        if (warp == 0) {
          // lane l holds bins 255 - 8l - q, q = 0..7, highest first
          unsigned cnt[8], sum = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            cnt[q] = h[255 - 8 * lane - q];
            sum += cnt[q];
          }
          unsigned incl = sum;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
          }
          const unsigned excl = incl - sum;
          if (excl < (unsigned)needed && (unsigned)needed <= incl) {
            unsigned above = excl;
            int q = 0;
            while (above + cnt[q] < (unsigned)needed) above += cnt[q++];
            const int rest = needed - (int)above;
            *sel_prefix = (prefix << 8) | (unsigned)(255 - 8 * lane - q);
            ctrl[0] = rest;
            ctrl[1] = cnt[q] == (unsigned)rest;
          }
        }
        __syncthreads();
        prefix = *sel_prefix;
        needed = ctrl[0];
        buf ^= 1;
        if (ctrl[1]) break;
      }
      for (int e = tid; e < n_cand; e += kThreads) {
        const unsigned long long key = cand_key(cand[e], e);
        if ((key >> shift) >= prefix) flist[atomicAdd(&ctrl[4], 1)] = key;
      }
      __syncthreads();
      m = k;
    }

    // each listed candidate's rank; the K best become the beams, slot = rank
    if (tid < m) {
      const unsigned long long key = flist[tid];
      int rank = 0;
      for (int q = 0; q < m; ++q) rank += flist[q] > key;
      if (rank < k) {
        const int e = 0xFFFF - (int)(key & 0xFFFFu);
        Beam nb;
        if (e < k) {
          nb = old[e];
          nb.pb = pb_stay[e];
          nb.pnb = pnb_stay[e];
        } else {
          const int j = (e - k) / c, ch = (e - k) - j * c;
          const Beam src = old[j];
          nb.pb = kNeg;
          nb.pnb = cand[e];
          nb.plen = src.plen + 1;
          nb.last = ch;
          if (src.node >= 0) {
            const int id = 1 + t * k + rank;
            arena[id] = ((unsigned)src.node << 16) | (unsigned)ch;
            nb.node = id;
            nb.hpar = src.hfull;
            nb.hfull = (src.hfull ^ (unsigned)(ch + 1)) * kHashMul;
          } else {  // a dead beam stays dead; its content does not change
            nb.node = src.node;
            nb.hpar = src.hpar;
            nb.hfull = src.hfull;
          }
        }
        nxt[rank] = nb;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  if (tid == 0) {
    const Beam* fin = beams + cur * k;
    int best = 0;
    float bt = lse(fin[0].pb, fin[0].pnb);
    for (int q = 1; q < k; ++q) {
      const float v = lse(fin[q].pb, fin[q].pnb);
      if (v > bt) {
        bt = v;
        best = q;
      }
    }
    const Beam b = fin[best];
    int olen;
    if (b.node < 0) {  // a dead beam's prefix: its first character
      obuf[0] = (short)b.node;
      for (int p = 1; p < t_len; ++p) obuf[p] = 0;
      olen = t_len;
    } else {
      int nd = b.node;
      for (int p = b.plen - 1; p >= 0; --p) {
        const unsigned a = arena[nd];
        obuf[p] = (short)(a & 0xFFFFu);
        nd = (int)(a >> 16);
      }
      olen = b.plen;
    }
    if (merge) {
      int w = 0, prev = -1;
      for (int p = 0; p < olen; ++p) {
        const int v = obuf[p];
        if (v != prev) obuf[w++] = (short)v;
        prev = v;
      }
      olen = w;
    }
    ctrl[3] = olen;
  }
  __syncthreads();
  const int olen = ctrl[3];
  int* orow = out + (long long)row * t_len;
  for (int p = tid; p < t_len; p += kThreads) orow[p] = p < olen ? obuf[p] : 0;
}

template <typename In>
int launch(const void* logits, long long stride_n, long long stride_t,
           const void* lens, void* out, int n_rows, int t_len, int k, int c,
           int blank, int merge, int bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<In><<<n_rows, kThreads, bytes, stream>>>(
      static_cast<const In*>(logits), stride_n, stride_t,
      static_cast<const int*>(lens), static_cast<int*>(out), t_len, k, c,
      blank, merge);
  return (int)cudaGetLastError();
}

}  // namespace

// logits: [N, T, C] f32 (bf16 = 0) or bf16 (bf16 = 1), the class axis
// contiguous, rows stride_n and frames stride_t elements apart; lens: [N]
// int32; out: [N, T] int32, the top beam's ids, 0-padded. shared_bytes must
// equal the layout's total (the wrapper computes it too).
extern "C" int ctc_beam_decode(const void* logits, int bf16, long long stride_n,
                               long long stride_t, const void* lens, void* out,
                               int n_rows, int t_len, int k, int c, int blank,
                               int merge, int shared_bytes, void* stream) {
  if (n_rows <= 0 || t_len <= 0 || k < 1 || k > kThreads || c < 1 ||
      c > kMaxClasses || k * (c + 1) > kMaxCandidates ||
      (long long)t_len * k >= kMaxNodes || blank < 0 || blank >= c)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(t_len, k, c);
  if (l.bytes != shared_bytes || l.bytes > kMaxShared)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(logits, stride_n, stride_t, lens, out,
                                      n_rows, t_len, k, c, blank, merge,
                                      l.bytes, st)
              : launch<float>(logits, stride_n, stride_t, lens, out, n_rows,
                              t_len, k, c, blank, merge, l.bytes, st);
}

// The shared memory a launch at T, K, C takes: layout()'s total.
extern "C" int ctc_beam_shared_bytes(int t_len, int k, int c) {
  return layout(t_len, k, c).bytes;
}
