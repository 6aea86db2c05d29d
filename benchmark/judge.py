"""How a decoded answer is judged against the reference.

A decoded label is right when the reference model scores it as high as
the label the reference's own decoder finds. The score is the one the
decoder maximises, under the reference's f32 log-probabilities: for a
prefix beam search the label's probability summed over its alignments
(the CTC forward), for a best-path decode its best alignment's. The gap of
an answer is the reference's own label's score less the answer's, and no
less than 0: 0 where the two labels agree, small where a lower precision
broke a near tie, large where the answer is wrong.
"""

from __future__ import annotations

import torch

from .reference import ctc as ref_ctc
from .reference import decode as ref_decode
from .reference import model as ref_model


def strip(ids):
    """A decoder's 0-padded row -> the list of its nonzero ids."""
    return [int(i) for i in ids if int(i) != 0]


def altered(labels):
    """The fault a comparison has to catch: the first example's first
    token changed to the next class (an empty label gains one)."""
    out = [list(x) for x in labels]
    out[0] = [out[0][0] % 62 + 1] + out[0][1:] if out[0] else [1]
    return out


def gaps(logits_tm, lens, answers, own, mode):
    """Per-example gaps: ``logits_tm`` [T, N, C] the reference's f32
    logits, ``lens`` [N] frames, ``answers`` and ``own`` lists of id lists
    (the answers judged and the reference decoder's), ``mode`` ``'beam'``
    (summed over alignments) or ``'greedy'`` (best alignment)."""
    logp = torch.log_softmax(logits_tm.float().transpose(0, 1), dim=-1)
    score = ref_ctc.label_logprob if mode == 'beam' else \
        ref_ctc.label_viterbi
    lens = lens.to(logp.device)
    a = score(logp, answers, lens)
    b = score(logp, own, lens)
    return torch.clamp(b - a, min=0.0).tolist()


def frame_gaps(logits_tm, low_tm, lens):
    """The control's reading, which needs no decode: at every live frame
    of every example, how far below the reference's best class the class
    that the lower precision puts first lies, in the reference's f32
    log-probabilities; the widest per example."""
    logp = torch.log_softmax(logits_tm.float(), dim=-1)          # [T, N, C]
    first = low_tm.float().argmax(dim=-1, keepdim=True)
    gap = logp.max(dim=-1).values - torch.gather(logp, 2, first)[..., 0]
    live = torch.arange(gap.shape[0], device=gap.device)[:, None] \
        < lens.to(gap.device)[None, :]
    return torch.where(live, gap, torch.zeros_like(gap)).max(dim=0) \
        .values.tolist()


def reference_logits(params, x, lens, cfg_d, prec=None):
    """The reference's logits [T, N, C] of a batch: f32, or the control's
    ``prec``, with the configuration's ``BN_EVAL`` statistics."""
    with torch.no_grad():
        return ref_model.forward(params, x, lens, prec=prec,
                                 moving_bn=cfg_d['BN_EVAL'] == 'moving')


def reference_decode(params, x, lens, cfg_d):
    """The reference's f32 logits [T, N, C] of a batch and its decoder's
    id lists, by the configuration's ``DECODER``."""
    logits = reference_logits(params, x, lens, cfg_d)
    bl = logits.transpose(0, 1)
    if cfg_d['DECODER'] == 'beam':
        ids = ref_decode.beam_decode(bl, lens,
                                     beam_width=int(cfg_d['BEAM_WIDTH']))
    else:
        ids = ref_decode.greedy_decode(bl, lens)
    return logits, [strip(r) for r in ids.cpu().numpy()]
