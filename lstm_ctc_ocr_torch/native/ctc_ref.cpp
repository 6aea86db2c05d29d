// Reference C++ implementation of the CTC forward-backward (loss + gradient):
// the port's copy of the JAX package's native/ctc_ref.cpp, an oracle for the
// CTC kernels (csrc/ctc.cu) that shares no code with them or with their
// plain PyTorch versions (ops/ctc.py).
//
// Convention (warp-ctc / tf.nn.ctc_loss):
//   blank index 0; per-example logit lengths and label lengths;
//   loss[n]  = -log p(label | logits), natural log (+inf where no alignment
//   exists);
//   grad[n,t,c] = d loss[n] / d logits[n,t,c]  (zero for t >= logit_len, and
//   for an example without an alignment).
//
// All internal math in double precision, log space.
//
// Built at first use by native/ctc_ref.py (g++, ops/_build.py:host_library).

#include <cmath>
#include <cstdint>
#include <vector>
#include <limits>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double log_sum_exp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

inline double log_sum_exp3(double a, double b, double c) {
  return log_sum_exp(log_sum_exp(a, b), c);
}

}  // namespace

extern "C" {

// logits:  [N, T, C] row-major float32
// labels:  [N, L] dense int32, 0-padded
// returns 0 on success
int ctc_loss_grad(const float* logits, const int32_t* labels,
                  const int32_t* label_lens, const int32_t* logit_lens,
                  int32_t N, int32_t T, int32_t C, int32_t L,
                  float* losses, float* grads) {
  for (int n = 0; n < N; ++n) {
    const int t_len = logit_lens[n];
    const int l_len = label_lens[n];
    // validate before touching any derived index: an out-of-range length
    // or label id would read past logits rows / write past the class
    // vector (silent heap corruption in the conformance oracle)
    if (t_len < 0 || t_len > T || l_len < 0 || l_len > L) return 1;
    for (int i = 0; i < l_len; ++i) {
      const int32_t v = labels[(size_t)n * L + i];
      if (v < 0 || v >= C) return 2;
    }
    const int S = 2 * l_len + 1;
    const float* lg = logits + (size_t)n * T * C;
    float* gr = grads ? grads + (size_t)n * T * C : nullptr;
    if (gr) {
      for (int i = 0; i < T * C; ++i) gr[i] = 0.0f;
    }

    // degenerate input lengths: no frames means no alignment exists for a
    // nonempty label (loss +inf, zero grad) and probability 1 for an empty
    // one; guards the unconditional alpha[0] write below against t_len<=0
    if (t_len <= 0) {
      losses[n] = l_len > 0 ? (float)(-kNegInf) : 0.0f;
      continue;
    }

    // extended label sequence: blank, l1, blank, l2, ..., blank
    std::vector<int> ext(S);
    for (int s = 0; s < S; ++s)
      ext[s] = (s % 2 == 1) ? labels[(size_t)n * L + (s - 1) / 2] : 0;

    // log-softmax per valid frame
    std::vector<double> logp((size_t)t_len * C);
    for (int t = 0; t < t_len; ++t) {
      const float* row = lg + (size_t)t * C;
      double mx = row[0];
      for (int c = 1; c < C; ++c) mx = std::max(mx, (double)row[c]);
      double z = 0.0;
      for (int c = 0; c < C; ++c) z += std::exp((double)row[c] - mx);
      double lz = mx + std::log(z);
      for (int c = 0; c < C; ++c) logp[(size_t)t * C + c] = (double)row[c] - lz;
    }

    auto g = [&](int t, int s) { return logp[(size_t)t * C + ext[s]]; };
    auto skip_ok = [&](int s) {
      return s % 2 == 1 && s >= 2 && ext[s] != ext[s - 2];
    };

    // forward (alpha includes the emission at t)
    std::vector<double> alpha((size_t)t_len * S, kNegInf);
    alpha[0] = g(0, 0);
    if (S > 1) alpha[1] = g(0, 1);
    for (int t = 1; t < t_len; ++t) {
      for (int s = 0; s < S; ++s) {
        double stay = alpha[(size_t)(t - 1) * S + s];
        double one = s >= 1 ? alpha[(size_t)(t - 1) * S + s - 1] : kNegInf;
        double two = skip_ok(s) ? alpha[(size_t)(t - 1) * S + s - 2] : kNegInf;
        alpha[(size_t)t * S + s] = g(t, s) + log_sum_exp3(stay, one, two);
      }
    }

    double log_z = alpha[(size_t)(t_len - 1) * S + S - 1];
    if (S > 1)
      log_z = log_sum_exp(log_z, alpha[(size_t)(t_len - 1) * S + S - 2]);
    losses[n] = (float)(-log_z);

    if (!gr) continue;
    if (log_z == kNegInf) continue;  // impossible alignment: grad left at 0

    // backward (beta includes the emission at t)
    std::vector<double> beta((size_t)t_len * S, kNegInf);
    beta[(size_t)(t_len - 1) * S + S - 1] = g(t_len - 1, S - 1);
    if (S > 1) beta[(size_t)(t_len - 1) * S + S - 2] = g(t_len - 1, S - 2);
    for (int t = t_len - 2; t >= 0; --t) {
      for (int s = 0; s < S; ++s) {
        double stay = beta[(size_t)(t + 1) * S + s];
        double one = s + 1 < S ? beta[(size_t)(t + 1) * S + s + 1] : kNegInf;
        double two = (s + 2 < S && skip_ok(s + 2))
                         ? beta[(size_t)(t + 1) * S + s + 2]
                         : kNegInf;
        beta[(size_t)t * S + s] = g(t, s) + log_sum_exp3(stay, one, two);
      }
    }

    // grad wrt logits: softmax(logits) - posterior over states emitting c
    for (int t = 0; t < t_len; ++t) {
      std::vector<double> post_c(C, kNegInf);  // log sum of posteriors per class
      for (int s = 0; s < S; ++s) {
        double lp = alpha[(size_t)t * S + s] + beta[(size_t)t * S + s] -
                    g(t, s) - log_z;
        post_c[ext[s]] = log_sum_exp(post_c[ext[s]], lp);
      }
      for (int c = 0; c < C; ++c) {
        double y = std::exp(logp[(size_t)t * C + c]);
        double p = post_c[c] == kNegInf ? 0.0 : std::exp(post_c[c]);
        gr[(size_t)t * C + c] = (float)(y - p);
      }
    }
  }
  return 0;
}

}  // extern "C"
