"""Attribute train-step time across its pieces: conv, BiLSTM and CTC,
forward against backward.

Counterpart of the JAX package's ``tools/profile_step.py``, with its flags,
defaults and JSON keys. Times each piece (median of windows, each closed by
a synchronising readback and timed by CUDA events on the card) and prints
one line a piece with its FLOP count and the implied rate and MFU, so that
the piece with low utilisation shows. The subtractive model:

    full_step      = fwd + bwd + solver update + BN moving statistics
    fwd_loss       = model forward + CTC
    model_fwd      = CNN + BiLSTM + projection
    ctc_fwd        = CTC loss on random logits of the same shape
    ctc_fwd_bwd    = the same, and its gradient

The pieces run the hand kernels on the card: the BiLSTM forward in
``fwd_loss``, ``model_fwd`` and ``full_step``, its backward in
``full_step``, the CTC forward in every piece but ``model_fwd``, its
backward in ``ctc_fwd_bwd`` and ``full_step``. ``full_step`` is the solver's
``engine/train.py:make_train_step``, its state (parameters, moments, BN
statistics, count) carried from call to call as the JAX tool threads it.

FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of the
library convolutions and products, plus what it cannot see inside the
hand kernels, counted from the shapes (``tools/_common.py:kernel_flops``):
the recurrent products over the batch's valid frames and the CTC
recursions. MFU is against the card's dense bf16 peak, null on a card
outside the table and on the CPU. The batch is rendered by
``cfg.RENDERER``, so on a machine without Pillow pass ``--set RENDERER
native``. Run::

    python -m lstm_ctc_ocr_torch.tools.profile_step [--batch 64 --width 96]
        [--device cpu] [--set KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import load_cfg
from ..engine.test import full_f32, resolve_device
from ..engine.train import (compute_dtype, make_loss_fn, make_optimizer,
                            make_train_step)
from ..models.factory import get_network
from ..ops import ctc_cuda
from ._common import (build_batches, count_flops, device_name, kernel_flops,
                      peak_flops_for, timed_ms)


def report(name, ms, flops, peak):
    """One piece's line: ms, GFLOPs, TFLOP/s achieved and MFU (null where
    not known)."""
    rate = flops / (ms / 1e3) if flops and ms else None
    row = {'piece': name, 'ms': round(ms, 3),
           'gflops': round(flops / 1e9, 2) if flops else None,
           'tflops_achieved': round(rate / 1e12, 2) if rate else None,
           'mfu': round(rate / peak, 4) if rate and peak else None}
    print(json.dumps(row), flush=True)
    return row


def add_common_args(ap, batch=64, width=96, windows=9, calls=50):
    ap.add_argument('--batch', type=int, default=batch)
    ap.add_argument('--width', type=int, default=width)
    ap.add_argument('--windows', type=int, default=windows)
    ap.add_argument('--calls', type=int, default=calls)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                    help='config overrides: KEY VALUE ...')


def setup(args):
    """The default config with ``--set`` and ``TRAIN.BATCH_SIZE``, the
    device, one rendered batch on it ``(image, label, label_len,
    time_step)``, padded to the bucket ``--width`` (or, as ``bucket_batch``
    does, the first doubling of it that fits the widest image), and the
    seeded ``LSTM_train`` there."""
    cfg = load_cfg(None, args.set_cfgs)
    cfg.TRAIN.BATCH_SIZE = args.batch
    dev = resolve_device(args.device)
    b = build_batches(cfg, args.batch, args.width, n_batches=1)[0]
    data = tuple(torch.from_numpy(a).to(dev) for a in
                 (b.image, b.label, b.label_len, b.time_step))
    model = get_network('LSTM_train', cfg, generator=torch.Generator()
                        .manual_seed(0)).to(dev).train()
    return cfg, dev, data, model


@full_f32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    args = ap.parse_args(argv)
    cfg, dev, (image, label, label_len, time_step), model = setup(args)
    # the batch's bucket: --width, or a wider one where an image needs it
    batch, width = args.batch, image.shape[1]
    kind = device_name(dev)
    peak = peak_flops_for(kind)
    dt = compute_dtype(cfg)
    optimizer = make_optimizer(model, cfg)
    step = make_train_step(model, optimizer, cfg, dt)
    loss_fn = make_loss_fn(model, cfg, dt)
    t_frames = width // int(cfg.POOL_SCALE) - 1
    per_launch = kernel_flops(int(time_step.sum()),
                              int(cfg.TRAIN.NUM_HID) // 2, batch, t_frames,
                              2 * label.shape[1] + 1)
    timing = dict(windows=args.windows, calls=args.calls, device=dev)

    def fwd(lb, ll, ts):
        with torch.no_grad():
            return loss_fn(image, lb, ll, ts)[0]

    def model_fwd(ts):
        with torch.no_grad():
            return model(image, ts, dtype=dt)

    logits = torch.from_numpy(np.random.RandomState(0).randn(
        batch, t_frames, int(cfg.NCLASSES)).astype(np.float32)).to(dev)

    def ctc_only(lg, lb, ll, ts):
        with torch.no_grad():
            return ctc_cuda.ctc_loss(lg, lb, ll, ts).mean()

    def ctc_grad(lg, lb, ll, ts):
        lg = lg.detach().requires_grad_()
        return torch.autograd.grad(ctc_cuda.ctc_loss(lg, lb, ll, ts).mean(),
                                   lg)[0]

    # labels and lengths are inputs of every call, as in the train step
    for name, fn, fargs in [
            ('fwd_loss (model+ctc)', fwd, (label, label_len, time_step)),
            ('model_fwd (cnn+bilstm+proj)', model_fwd, (time_step,)),
            ('ctc_fwd', ctc_only, (logits, label, label_len, time_step)),
            ('ctc_fwd_bwd', ctc_grad, (logits, label, label_len, time_step)),
    ]:
        flops = count_flops(fn, *fargs, per_launch=per_launch)
        report(name, timed_ms(fn, *fargs, **timing), flops, peak)

    # the full step, its state carried in place from call to call
    flops = count_flops(step, image, label, label_len, time_step,
                        per_launch=per_launch)
    ms = timed_ms(step, image, label, label_len, time_step, **timing)
    report('full_step (fwd+bwd+adam)', ms, flops, peak)
    impl = 'kernels' if dev.type == 'cuda' else 'plain'
    print(json.dumps({'device': kind, 'batch': batch, 'width': width,
                      'lstm_impl': impl, 'ctc_impl': impl}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
