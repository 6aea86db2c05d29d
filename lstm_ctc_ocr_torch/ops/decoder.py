"""CTC best-path decoding (counterpart of the JAX package's
``ops/decoder.py``; the beam decoder is not ported yet)."""

from __future__ import annotations

import torch


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
