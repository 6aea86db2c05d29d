"""Attribute the train step's time by the deltas between variants of it.

Counterpart of the JAX package's ``tools/attrib_step.py``, with its flags,
defaults and JSON keys. A lone call of a small piece pays launch and host
costs that the step around it hides (``tools/profile_step.py`` times pieces
alone), so this tool times the FULL train step under variants, with
identical windows, and reports the deltas, in which those costs cancel:

* ``ctc=kernel lstm=kernel``: the solver's step (``engine/train.py:
  make_train_step``), the BiLSTM and CTC kernels, each once a step;
* ``ctc=plain lstm=kernel``: the CTC loss as the plain PyTorch recursions
  (``make_loss_fn(ctc_loss=ops/ctc.py:ctc_loss)``);
* ``ctc=kernel lstm=plain``: the BiLSTM as the plain two-scan pair (the head
  built with ``layers.BiLSTM(recurrence=ops/rnn.py:bilstm_scan_pair)``);
* ``ctc=none lstm=kernel``: the CTC loss replaced by the JAX tool's dummy,
  ``mean(logits^2)`` + the L2 term (:func:`dummy_loss_fn`), with no BN
  moving-statistics update, as the JAX dummy step keeps ``bn`` unchanged;
* ``conv=shifted``: the kernels' step with conv2 to conv5 lowered to
  shifted matmuls (``CONV_IMPL: shifted``, ``ops/conv.py``).

The first four take the config's ``CONV_IMPL`` (``'xla'``, cuDNN, by
default), as the JAX tool's do.

Every variant starts from the same weights with a fresh solver, takes
``--warm`` steps (200, the JAX tool's count) and then ``--windows`` windows
of ``--calls`` steps on one rendered batch, each window closed by the loss's
readback and timed by CUDA events on the card. The delta line keeps the JAX
keys, whose ``pallas`` here means the hand kernels and ``scan`` the plain
PyTorch versions: ``delta_ctc_pallas_vs_scan_ms`` is the kernels' step less
the plain-CTC step, ``delta_ctc_pallas_vs_none_ms`` the kernels' step less
the dummy-loss step, ``delta_lstm_pallas_vs_scan_ms`` the kernels' step less
the plain-BiLSTM step. As in the JAX tool, ``conv=shifted`` has its
variant line and no delta key: its delta is its step less the first
variant's. The batch is rendered by ``cfg.RENDERER`` (``--set RENDERER
native`` without Pillow). Run::

    python -m lstm_ctc_ocr_torch.tools.attrib_step [--batch 64 --width 96]
        [--device cpu] [--set KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import torch

from ..engine.test import full_f32
from ..engine.train import (compute_dtype, make_loss_fn, make_optimizer,
                            make_train_step)
from ..models.crnn import LSTM_train
from ..models.layers import BiLSTM
from ..ops import ctc, rnn
from ._common import device_name, readback, timed_ms
from .profile_step import add_common_args, setup


def dummy_loss_fn(model, cfg, dtype):
    """The JAX tool's dummy loss (``make_dummy_step``): the same model
    forward, then ``mean(logits^2)`` in f32 plus the L2 term in place of the
    CTC loss; ``(total, total, [])``, so that the step updates no BN moving
    statistics."""
    weight_decay = float(cfg.TRAIN.WEIGHT_DECAY)

    def loss_fn(image, label, label_len, time_step):
        lg = model(image, time_step, dtype=dtype).float()
        total = torch.mean(lg * lg) + model.regularization_loss(weight_decay)
        return total, total, []
    return loss_fn


class _PlainBiLSTM(LSTM_train):
    """The model with the plain two-scan BiLSTM head."""

    def make_head(self, num_hid, nclasses, generator):
        return BiLSTM(512, num_hid, nclasses, generator,
                      recurrence=rnn.bilstm_scan_pair)


def variants(base, cfg, dtype):
    """``[(name, model, make_step)]``: each variant's model (a copy of
    ``base``'s weights) and the factory of its step, ``make_step(model,
    optimizer)``."""
    def copy_of(kind, conv_impl):
        m = kind(int(cfg.NCHANNELS), int(cfg.TRAIN.NUM_HID),
                 int(cfg.NCLASSES), conv_impl=conv_impl)
        m.load_state_dict(base.state_dict())
        return m.to(next(base.parameters()).device).train()

    def kernels(m, o):
        return make_train_step(m, o, cfg, dtype)

    def plain_ctc(m, o):
        return make_train_step(m, o, cfg, dtype, loss_fn=make_loss_fn(
            m, cfg, dtype, ctc_loss=ctc.ctc_loss))

    def no_ctc(m, o):
        return make_train_step(m, o, cfg, dtype,
                               loss_fn=dummy_loss_fn(m, cfg, dtype))
    conv_impl = str(cfg.CONV_IMPL)
    return [('ctc=kernel lstm=kernel', copy.deepcopy(base), kernels),
            ('ctc=plain lstm=kernel', copy.deepcopy(base), plain_ctc),
            ('ctc=kernel lstm=plain', copy_of(_PlainBiLSTM, conv_impl),
             kernels),
            ('ctc=none lstm=kernel', copy.deepcopy(base), no_ctc),
            ('conv=shifted', copy_of(LSTM_train, 'shifted'), kernels)]


@full_f32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, calls=100)
    ap.add_argument('--warm', type=int, default=200,
                    help='steps taken before the timed windows')
    args = ap.parse_args(argv)
    cfg, dev, data, base = setup(args)
    dtype = compute_dtype(cfg)

    results = {}
    for name, model, make_step in variants(base, cfg, dtype):
        step = make_step(model, make_optimizer(model, cfg))
        for _ in range(args.warm):
            total = step(*data)[0]
        if args.warm:
            readback(total)
        # timed_ms's first call is one more warm step
        ms = timed_ms(step, *data, windows=args.windows, calls=args.calls,
                      device=dev)
        results[name] = ms
        print(json.dumps({'variant': name, 'ms_per_step': round(ms, 3)}),
              flush=True)
    base_ms = results['ctc=kernel lstm=kernel']
    print(json.dumps({
        'delta_ctc_pallas_vs_scan_ms': round(
            base_ms - results['ctc=plain lstm=kernel'], 3),
        'delta_ctc_pallas_vs_none_ms': round(
            base_ms - results['ctc=none lstm=kernel'], 3),
        'delta_lstm_pallas_vs_scan_ms': round(
            base_ms - results['ctc=kernel lstm=plain'], 3),
        'device': device_name(dev)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
