"""CTC decoding in plain PyTorch: best-path (greedy) decoding and the
prefix beam search with merging of colliding prefixes and ties broken
towards the lowest candidate index. A frozen copy of the plain versions
the program's decoders follow, step for step.
"""

from __future__ import annotations

import torch

from .ctc import NEG_INF


def greedy_decode(logits, logit_lens, blank: int = 0):
    """Best-path CTC decode: argmax per frame, collapse repeats, drop blanks.

    Args:
      logits:     [N, T, C] (batch-major).
      logit_lens: [N] valid frame counts.
    Returns:
      [N, T] int32 decoded ids, left-packed and 0-padded on the right.
    """
    n, t_len, _ = logits.shape
    ids = logits.argmax(dim=-1).to(torch.int32)                 # first max
    t_idx = torch.arange(t_len, device=logits.device)[None, :]
    in_range = t_idx < logit_lens.to(logits.device)[:, None]
    ids = torch.where(in_range, ids, torch.full_like(ids, blank))
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & in_range
    # kept ids go to their rank among kept frames; dropped frames go to the
    # spare column t_len, which is cut off
    pos = torch.where(keep, keep.to(torch.int64).cumsum(dim=1) - 1,
                      torch.full_like(ids, t_len, dtype=torch.int64))
    out = torch.zeros(n, t_len + 1, dtype=torch.int32, device=logits.device)
    out.scatter_(1, pos, ids)
    return out[:, :t_len]


def _lse(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG_INF)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def _row_lse(v):
    """logsumexp over the last axis (NEG_INF-safe)."""
    m = v.max(dim=-1).values
    m_safe = torch.clamp(m, min=NEG_INF)
    out = m_safe + torch.log(torch.exp(v - m_safe[..., None]).sum(dim=-1))
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def _take(x, idx):
    """x [N, K, ...], idx [N, K'] -> x[n, idx[n, k']] as [N, K', ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


@torch.no_grad()
def beam_decode(logits, logit_lens, beam_width=16, blank=0,
                merge_repeated=False):
    """Batched CTC beam search.

    Args:
      logits:     [N, T, C] batch-major.
      logit_lens: [N] valid frame counts.
      merge_repeated: collapse adjacent repeats in the decoded output.
    Returns:
      [N, T] int32 dense decoded ids (top beam), 0-padded.
    """
    n, t_len, c = logits.shape
    k = beam_width
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    length = logit_lens.to(torch.int64)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    # Beam 0 holds the empty prefix; beams 1..K-1 start dead. The dead beams
    # carry unique negative first characters and an impossible length, so
    # that live beams are pairwise distinct keys from t = 0 (K duplicate
    # empty prefixes could otherwise each absorb the same extend mass).
    arange_k = torch.arange(k, device=dev)
    prefixes = torch.zeros(n, k, t_len, dtype=torch.int64, device=dev)
    if t_len:
        prefixes[:, 1:, 0] = -(arange_k[1:] + 1)
    plens = torch.where(arange_k == 0, 0, t_len).expand(n, k).contiguous()
    last = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    p_b = torch.where(arange_k == 0, 0.0, neg).expand(n, k).contiguous()
    p_nb = torch.full((n, k), NEG_INF, dtype=torch.float32, device=dev)

    class_ids = torch.arange(c, device=dev)
    pos = torch.arange(t_len, device=dev)

    for t in range(t_len):
        y = logp[:, t]                                      # [N, C]
        total = _lse(p_b, p_nb)
        has_last = last >= 0
        last0 = torch.clamp(last, min=0)

        # stay candidates (same prefix): blank emission + repeat emission
        new_pb_stay = total + y[:, blank:blank + 1]
        y_last = torch.where(has_last, torch.gather(y, 1, last0), neg)
        new_pnb_stay = p_nb + y_last

        # extend candidates [N, K, C]: c == last uses p_b only (a repeat
        # needs an intervening blank), else p_b + p_nb
        base = torch.where(class_ids[None, None, :] == last[:, :, None],
                           p_b[:, :, None], total[:, :, None])
        ext = base + y[:, None, :]
        ext[:, :, blank] = NEG_INF                 # blank never extends

        # exact cross-beam prefix merge: the only possible key collision is
        # a stay(i) with an ext(j, ch) where P_i == P_j + [ch], i.e. ch ==
        # last_i and P_j is P_i minus its last character. Positions >= plen
        # are always 0, so masked content equality identifies it exactly.
        content_eq = ((prefixes[:, :, None, :] == prefixes[:, None, :, :])
                      | (pos >= plens[:, None, :, None])).all(dim=-1)
        m_ij = (plens[:, :, None] == plens[:, None, :] + 1) & content_eq

        # mass of ext(j, last_i) as [N, i, j]
        ext_at_last = torch.gather(
            ext, 2, last0[:, None, :].expand(n, k, k)).transpose(1, 2)
        extra = torch.where(m_ij & has_last[:, :, None], ext_at_last, neg)
        new_pnb_stay = _lse(new_pnb_stay, _row_lse(extra))
        stay_total = _lse(new_pb_stay, new_pnb_stay)

        # kill the merged ext candidates so their mass is not counted twice
        kill = (m_ij[:, :, :, None]
                & (class_ids == last[:, :, None, None])).any(dim=1)
        ext = torch.where(kill, neg, ext)

        # the merged map's entries are pairwise distinct: prune to K
        ext_flat = ext.reshape(n, k * c)
        all_scores = torch.cat([stay_total, ext_flat], dim=1)
        top_idx = torch.sort(all_scores, dim=1, descending=True,
                             stable=True).indices[:, :k]

        is_stay = top_idx < k
        ext_idx = torch.clamp(top_idx - k, min=0)
        src = torch.where(is_stay, top_idx, ext_idx // c)
        ext_char = torch.where(is_stay, 0, ext_idx % c)

        new_prefixes = _take(prefixes, src)
        new_plens = _take(plens, src)
        # append ext_char at position plens[src] for extend candidates
        append = (pos == new_plens[:, :, None]) & ~is_stay[:, :, None]
        new_prefixes = torch.where(append, ext_char[:, :, None], new_prefixes)
        new_plens = torch.where(is_stay, new_plens, new_plens + 1)
        new_last = torch.where(is_stay, _take(last, src), ext_char)
        new_pb = torch.where(is_stay, _take(new_pb_stay, src), neg)
        new_pnb = torch.where(is_stay, _take(new_pnb_stay, src),
                              torch.gather(ext_flat, 1, ext_idx))

        # masked frames (t >= length) keep the previous state
        live = (t < length)[:, None]
        prefixes = torch.where(live[:, :, None], new_prefixes, prefixes)
        plens = torch.where(live, new_plens, plens)
        last = torch.where(live, new_last, last)
        p_b = torch.where(live, new_pb, p_b)
        p_nb = torch.where(live, new_pnb, p_nb)

    best = torch.argmax(_lse(p_b, p_nb), dim=1, keepdim=True)   # [N, 1]
    out = _take(prefixes, best)[:, 0]                            # [N, T]
    pos_valid = pos[None, :] < _take(plens, best)
    if merge_repeated:
        prev = torch.cat([out.new_full((n, 1), -1), out[:, :-1]], dim=1)
        keep = (out != prev) & pos_valid
        # kept ids move to the front; the rest land in a column cut off
        tgt = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t_len)
        merged = out.new_zeros(n, t_len + 1)
        merged.scatter_(1, tgt, torch.where(keep, out, 0))
        return merged[:, :t_len].to(torch.int32)
    return torch.where(pos_valid, out, 0).to(torch.int32)
