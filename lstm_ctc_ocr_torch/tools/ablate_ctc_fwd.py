"""Where a step of the CTC forward's warp kernel goes.

Builds copies of ``csrc/ctc.cu`` with parts of the step of
``ctc_fwd_warp_kernel`` taken out, and times each copy's warp kernel on the
device at batch 64, T = 23, L = 6 (S = 13, K = 1) and T = 111, L = 24
(S = 49, K = 2), the shapes of ``chip_smoke.py``'s CTC timings:

* ``full``: the kernel as it is;
* ``no_lse``: ``lse3`` becomes the maximum of its three terms (no ``expf``
  or ``logf`` on the chain);
* ``no_shuffle``: the s-1 and s-2 neighbours come from the lane's own
  state instead of ``__shfl_up_sync``;
* ``no_store``: the per-step store of alphas is left out;
* ``skeleton``: all three taken out, leaving the staged reads, the adds,
  the clamp and the loop.

The copies but ``full`` compute wrong outputs on purpose: only their times
mean anything. Each line is the device time of the warp kernel (median
over ``torch.profiler`` passes of 20 calls) and its time per step::

    python -m lstm_ctc_ocr_torch.tools.ablate_ctc_fwd

Needs the GPU machine (nvcc and a card); the copies are built under the
ignored ``lstm_ctc_ocr_torch/build/ablate/``.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from ..engine.test import resolve_device
from ..ops import _build, ctc, ctc_cuda
from .ablate_lstm_bwd import build_variants, card_name, recurrence_ms

_LSE = 'lse3(alpha[k], one[k], two[k] + sk[k])'
_SHFL1 = '__shfl_up_sync(0xffffffffu, alpha[k], 1)'
_SHFL2 = '__shfl_up_sync(0xffffffffu, alpha[0], 2)'
_STORE = 'store_if(row + lane * K + k, alpha[k], act[k]);'
ABLATIONS = {
    'full': [],
    'no_lse': [(_LSE, 'fmaxf(fmaxf(alpha[k], one[k]), two[k] + sk[k])')],
    'no_shuffle': [(_SHFL1, 'alpha[k]'), (_SHFL2, 'alpha[0]')],
    'no_store': [(_STORE, ';')],
}
ABLATIONS['skeleton'] = (ABLATIONS['no_lse'] + ABLATIONS['no_shuffle']
                         + ABLATIONS['no_store'])


def forward_args(t_len, l_max, n=64, classes=64, seed=7):
    """The kernel's inputs at one shape, on the card: g gathered from
    seeded log-probabilities and the three masks, labels of L characters
    and lengths near T, as an eval bucket's."""
    rng = np.random.RandomState(seed)
    logp = torch.log_softmax(torch.from_numpy(
        rng.randn(n, t_len, classes).astype(np.float32) * 2).cuda(), -1)
    labels = torch.from_numpy(rng.randint(1, classes, (n, l_max))).cuda()
    ext = ctc.extended_labels(labels)
    lens = torch.from_numpy(rng.randint(max(1, t_len - 8), t_len + 1, n)
                            .astype(np.int32)).cuda()
    skip, final, valid = (ctc._as_additive(m) for m in ctc._transition_masks(
        ext, torch.full((n,), l_max, dtype=torch.int32, device='cuda')))
    return ctc._gather_logp(logp, ext, lens).contiguous(), skip, valid, final


def main():
    resolve_device('cuda')
    card = card_name()
    builds = build_variants('ctc', 'ctc.cu', ABLATIONS)
    try:
        for t_len, l_max in ((23, 6), (111, 24)):
            args = forward_args(t_len, l_max)
            for variant, so in builds.items():
                _build._loaded['ctc'] = ctypes.CDLL(so)
                ms = recurrence_ms(args, fn=ctc_cuda.ctc_forward,
                                   kernel='ctc_fwd_warp_kernel')
                print(json.dumps({
                    'kernel': 'ctc_fwd', 'variant': variant, 't': t_len,
                    'l': l_max, 'n': 64, 'device_ms': ms,
                    'us_per_step': 1e3 * ms / (t_len - 1) if ms else None,
                    'device': card}), flush=True)
    finally:
        _build._loaded.pop('ctc', None)
    return 0


if __name__ == '__main__':
    sys.exit(main())
