"""CTC in plain PyTorch: the log-space alpha and beta recursions with the
analytic gradient (a frozen copy of the plain version the program's CTC
kernels are held to), and the scores the decode cells are judged by: the
log-likelihood of a label (:func:`label_logprob`, the sum over alignments
that a prefix beam search ranks by) and of its best alignment
(:func:`label_viterbi`, the max over alignments that a greedy decode
maximises).

Blank is class 0; ``NEG_INF = -1e30`` stands in for log 0; an infeasible
example (input too short for its label) has the 1e30 loss and no gradient.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30   # large-negative stand-in for log(0); avoids nan from inf-inf


def _logsumexp3(a, b, c):
    """Stable log(e^a + e^b + e^c) with the NEG_INF clamps."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=NEG_INF)          # keep exp args finite
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def _shift_right(x, fill=NEG_INF):
    """x[..., s] -> x[..., s-1]; ``fill`` at s = 0."""
    pad = x.new_full(x.shape[:-1] + (1,), fill)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def _shift_left(x, fill=NEG_INF):
    """x[..., s] -> x[..., s+1]; ``fill`` at the last s."""
    pad = x.new_full(x.shape[:-1] + (1,), fill)
    return torch.cat([x[..., 1:], pad], dim=-1)


def extended_labels(labels):
    """Dense labels [N, L] -> extended [N, 2L+1] with blanks interleaved."""
    n, l = labels.shape
    ext = labels.new_zeros((n, 2 * l + 1))
    ext[:, 1::2] = labels
    return ext


def _transition_masks(ext, label_lens):
    """Boolean per-state masks ``(skip, final, valid)``, each [N, S].

    ``skip[s]``: a path may hop ``s-2 -> s`` (s is a label state whose label
    differs from the previous label). ``final``: the last label state and
    the trailing blank, ``S_eff-2`` and ``S_eff-1`` with ``S_eff = 2*len+1``.
    ``valid``: ``s < S_eff``.
    """
    n, s_len = ext.shape
    s_idx = torch.arange(s_len, device=ext.device)[None, :].expand(n, s_len)
    is_label = (s_idx % 2) == 1
    prev2 = torch.cat([ext.new_zeros((n, 2)), ext[:, :-2]], dim=1)
    skip = is_label & (ext != prev2)
    s_eff = (2 * label_lens.to(torch.int64) + 1)[:, None]
    final = (s_idx == s_eff - 1) | (s_idx == s_eff - 2)
    valid = s_idx < s_eff
    return skip, final, valid


def _gather_logp(logp, ext, logit_lens):
    """g[n,t,s] = logp[n,t,ext[s]], with free-blank padding for t >= len."""
    n, t_len, _ = logp.shape
    idx = ext.to(torch.int64)[:, None, :].expand(n, t_len, ext.shape[1])
    g = torch.gather(logp, 2, idx)                                # [N, T, S]
    t_idx = torch.arange(t_len, device=logp.device)[None, :]
    in_range = (t_idx < logit_lens[:, None])[:, :, None]          # [N, T, 1]
    pad_val = torch.where(ext == 0, 0.0, NEG_INF)[:, None, :]     # [N, 1, S]
    return torch.where(in_range, g, pad_val.to(g.dtype))


def _as_additive(mask):
    """Boolean mask -> additive f32 mask: 0 where true, NEG_INF elsewhere."""
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def ctc_forward_reference(g, skip, valid, final):
    """Alpha recursion — the plain version of the ``ctc_fwd`` kernel.

    Args:
      g: [N, T, S] f32 gathered log-probabilities (:func:`_gather_logp`).
      skip, valid, final: [N, S] f32 additive masks (0 / NEG_INF).
    Returns:
      ``(logz [N], alphas [N, T, S])``; ``logz`` is NEG_INF for an
      infeasible example.
    """
    n, t_len, s_len = g.shape
    lane = torch.arange(s_len, device=g.device)[None, :]
    alpha = torch.where(lane <= 1, g[:, 0], torch.full_like(g[:, 0], NEG_INF)) \
        + valid
    alphas = [alpha]
    for t in range(1, t_len):
        one = _shift_right(alpha)
        two = _shift_right(one) + skip
        alpha = g[:, t] + _logsumexp3(alpha, one, two) + valid
        alpha = torch.clamp(alpha, min=NEG_INF)            # keep finite
        alphas.append(alpha)
    fin = alpha + final
    m = fin.max(dim=1, keepdim=True).values
    m_safe = torch.clamp(m, min=NEG_INF)
    logz = m_safe + torch.log(torch.exp(fin - m_safe).sum(dim=1, keepdim=True))
    logz = torch.where(m > NEG_INF / 2, logz, torch.full_like(logz, NEG_INF))
    return logz[:, 0], torch.stack(alphas, dim=1)


def ctc_backward_reference(g, skip, valid, final, alphas, logz, lens):
    """Beta recursion and per-state posteriors — the plain version of the
    ``ctc_bwd`` kernel.

    Args as :func:`ctc_forward_reference`, plus its two results and
    ``lens`` [N] int32 valid frame counts. Returns ``grad_g`` [N, T, S]:
    ``-exp(min(alpha+beta-g-logZ, 0))``, zero for ``t >= lens``, for
    unreachable states and for the whole of an infeasible example.
    """
    n, t_len, s_len = g.shape
    # additive mask at source s for the s -> s+2 hop: skip[s+2]
    skip_fwd = _shift_left(_shift_left(skip))
    lz = logz[:, None]
    feasible = (lz > NEG_INF / 2).to(g.dtype)                     # [N, 1]
    lens = lens.to(torch.int64)[:, None]
    grad = torch.empty_like(g)

    def emit(t, beta):
        lg = alphas[:, t] + beta - g[:, t] - lz
        post = torch.where(lg > NEG_INF / 2,
                           torch.exp(torch.clamp(lg, max=0.0)),
                           torch.zeros_like(lg))
        grad[:, t] = -post * feasible * (t < lens).to(g.dtype)

    beta = torch.clamp(g[:, t_len - 1] + final + valid, min=NEG_INF)
    emit(t_len - 1, beta)
    for t in range(t_len - 2, -1, -1):
        one = _shift_left(beta)
        two = _shift_left(one) + skip_fwd
        beta = g[:, t] + _logsumexp3(beta, one, two) + valid
        beta = torch.clamp(beta, min=NEG_INF)
        emit(t, beta)
    return grad


class _CTCOnLogp(torch.autograd.Function):
    """Per-example loss on log-probabilities, with the analytic gradient.
    ``run_forward`` / ``run_backward`` are the two recursions: the plain
    versions above, or the wrappers of ``ops/ctc_cuda.py``."""

    @staticmethod
    def forward(ctx, logp, labels, label_lens, logit_lens, run_forward,
                run_backward):
        ext = extended_labels(labels)
        skip, final, valid = (_as_additive(m) for m in
                              _transition_masks(ext, label_lens))
        g = _gather_logp(logp, ext, logit_lens).contiguous()
        logz, alphas = run_forward(g, skip, valid, final)
        ctx.save_for_backward(g, skip, valid, final, alphas, logz, ext,
                              logit_lens)
        ctx.n_classes = logp.shape[2]
        ctx.run_backward = run_backward
        return -logz

    @staticmethod
    def backward(ctx, dloss):
        g, skip, valid, final, alphas, logz, ext, logit_lens = \
            ctx.saved_tensors
        grad_g = ctx.run_backward(g, skip, valid, final, alphas, logz,
                                  logit_lens.to(torch.int32))
        # scatter S-space -> class space with a one-hot batched matmul
        onehot = torch.nn.functional.one_hot(
            ext.to(torch.int64), ctx.n_classes).to(grad_g.dtype)  # [N, S, C]
        grad_logp = torch.bmm(grad_g, onehot) * dloss[:, None, None]
        return grad_logp, None, None, None, None, None


def ctc_loss_with(run_forward, run_backward, logits, labels, label_lens,
                  logit_lens):
    """:func:`ctc_loss` over a given pair of recursions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _CTCOnLogp.apply(logp, labels, label_lens, logit_lens,
                            run_forward, run_backward)


def ctc_loss(logits, labels, label_lens, logit_lens):
    """Per-example CTC negative log-likelihood, plain PyTorch throughout.

    Args:
      logits:     [N, T, C] unnormalised scores (batch-major; class 0 = blank).
      labels:     [N, L] dense int labels, 0-padded.
      label_lens: [N] true label lengths.
      logit_lens: [N] valid frame counts.
    Returns:
      [N] float32 losses; 1e30 for an infeasible example.
    """
    return ctc_loss_with(ctc_forward_reference, ctc_backward_reference,
                         logits, labels, label_lens, logit_lens)


def _dense_labels(ids_list, device):
    """Lists of ids -> dense [N, max(1, L)] int64 and lengths [N] int32."""
    l_max = max([1] + [len(x) for x in ids_list])
    dense = torch.zeros(len(ids_list), l_max, dtype=torch.int64)
    for i, ids in enumerate(ids_list):
        if len(ids):
            dense[i, :len(ids)] = torch.as_tensor(list(ids), dtype=torch.int64)
    lens = torch.tensor([len(x) for x in ids_list], dtype=torch.int32)
    return dense.to(device), lens.to(device)


@torch.no_grad()
def label_logprob(logp, ids_list, logit_lens):
    """log P(label | x), summed over alignments, of each example's label
    ``ids_list[n]`` under log-probabilities ``logp`` [N, T, C]; NEG_INF
    where no alignment fits."""
    labels, label_lens = _dense_labels(ids_list, logp.device)
    ext = extended_labels(labels)
    skip, final, valid = (_as_additive(m) for m in
                          _transition_masks(ext, label_lens))
    g = _gather_logp(logp.float(), ext, logit_lens)
    logz, _ = ctc_forward_reference(g, skip, valid, final)
    return logz


@torch.no_grad()
def label_viterbi(logp, ids_list, logit_lens):
    """The log-probability of each label's best alignment (max over
    alignments instead of the sum): the score a best-path decode
    maximises. NEG_INF where no alignment fits."""
    labels, label_lens = _dense_labels(ids_list, logp.device)
    ext = extended_labels(labels)
    skip, final, valid = (_as_additive(m) for m in
                          _transition_masks(ext, label_lens))
    g = _gather_logp(logp.float(), ext, logit_lens)
    t_len, s_len = g.shape[1], g.shape[2]
    lane = torch.arange(s_len, device=g.device)[None, :]
    alpha = torch.where(lane <= 1, g[:, 0],
                        torch.full_like(g[:, 0], NEG_INF)) + valid
    for t in range(1, t_len):
        one = _shift_right(alpha)
        two = _shift_right(one) + skip
        best = torch.maximum(torch.maximum(alpha, one), two)
        alpha = torch.clamp(g[:, t] + best + valid, min=NEG_INF)
    out = (alpha + final).max(dim=1).values
    return torch.where(out > NEG_INF / 2, out, torch.full_like(out, NEG_INF))
