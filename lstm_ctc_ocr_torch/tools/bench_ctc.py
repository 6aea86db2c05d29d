"""Micro-benchmark: the CTC loss, plain and on the hand kernels, and its
pieces.

Counterpart of the JAX package's ``tools/bench_ctc.py``, with its flags,
defaults and JSON keys. Times (median of windows, each closed by a
synchronising readback and timed by CUDA events on the card):

* ``impl`` 'plain': ``ops/ctc.py:ctc_loss``, the plain PyTorch recursions
  (the JAX tool's 'scan'), forward and forward+backward;
* ``impl`` 'kernels': ``ops/ctc_cuda.ctc_loss``, the CTC forward and
  backward kernels of ``csrc/ctc.cu`` (the JAX tool's 'pallas');
* ``piece`` 'prep(ext+masks+gather)': the prep alone, the extended labels,
  the transition masks and the class-to-state gather
  (``ops/ctc.py:extended_labels``, ``_transition_masks``, ``_gather_logp``);
* ``piece`` 'ctc_forward_kernel_only': ``ctc_cuda.ctc_forward`` alone on
  prepared inputs.

Labels and lengths are inputs of every timed call, as in the train step.
Run::

    python -m lstm_ctc_ocr_torch.tools.bench_ctc [--batch 64 --frames 23]
        [--device cpu]

On the CPU the 'kernels' rows run the plain recursions (the wrappers take
their plain version for CPU tensors): a check of the plumbing.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..engine.test import full_f32, resolve_device
from ..ops import ctc, ctc_cuda
from ._common import device_name, timed_ms


def prep(logp, labels, label_lens, logit_lens):
    """The recursions' inputs: ``g`` [N, T, S] and the additive ``skip``,
    ``valid`` and ``final`` masks [N, S] (``ctc_loss``'s own prep)."""
    ext = ctc.extended_labels(labels)
    skip, final, valid = (ctc._as_additive(m) for m in
                          ctc._transition_masks(ext, label_lens))
    g = ctc._gather_logp(logp, ext, logit_lens).contiguous()
    return g, skip, valid, final


@full_f32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--frames', type=int, default=23)
    ap.add_argument('--classes', type=int, default=64)
    ap.add_argument('--maxlen', type=int, default=6)
    ap.add_argument('--windows', type=int, default=9)
    ap.add_argument('--calls', type=int, default=50)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(a).to(dev)
    logits = put(rng.randn(args.batch, args.frames, args.classes)
                 .astype(np.float32))
    labels = put(rng.randint(1, args.classes - 1,
                             size=(args.batch, args.maxlen)).astype(np.int32))
    label_lens = put(rng.randint(max(1, args.maxlen - 2), args.maxlen + 1,
                                 size=(args.batch,)).astype(np.int32))
    logit_lens = torch.full((args.batch,), args.frames, dtype=torch.int32,
                            device=dev)
    timing = dict(windows=args.windows, calls=args.calls, device=dev)

    for name, impl in (('plain', ctc.ctc_loss),
                       ('kernels', ctc_cuda.ctc_loss)):
        def fwd(lg, lb, ll, tl, f=impl):
            with torch.no_grad():
                return f(lg, lb, ll, tl).mean()

        def fwd_bwd(lg, lb, ll, tl, f=impl):
            lg = lg.detach().requires_grad_()
            return torch.autograd.grad(f(lg, lb, ll, tl).mean(), lg)[0]
        print(json.dumps({
            'impl': name,
            'fwd_ms': round(timed_ms(fwd, logits, labels, label_lens,
                                     logit_lens, **timing), 3),
            'fwd_bwd_ms': round(timed_ms(fwd_bwd, logits, labels,
                                         label_lens, logit_lens, **timing),
                                3)}), flush=True)

    # the pieces of the kernels' path
    logp = torch.log_softmax(logits, dim=-1)
    g, skip, valid, final = prep(logp, labels, label_lens, logit_lens)
    print(json.dumps({'piece': 'prep(ext+masks+gather)',
                      'ms': round(timed_ms(prep, logp, labels, label_lens,
                                           logit_lens, **timing), 3)}),
          flush=True)
    print(json.dumps({'piece': 'ctc_forward_kernel_only',
                      'ms': round(timed_ms(
                          lambda *a: ctc_cuda.ctc_forward(*a)[0], g, skip,
                          valid, final, **timing), 3)}), flush=True)
    print(json.dumps({'device': device_name(dev),
                      'shape': [args.batch, args.frames, args.classes]}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
