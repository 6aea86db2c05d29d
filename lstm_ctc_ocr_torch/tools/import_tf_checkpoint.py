"""Convert a reference TF1 checkpoint of the CRNN to a ``.npy`` pre-train
dict.

Counterpart of the JAX package's ``tools/import_tf_checkpoint.py``, with its
command line, functions and output::

    python -m lstm_ctc_ocr_torch.tools.import_tf_checkpoint CKPT [--out OUT]

It reads a TF checkpoint of the reference graph (``LSTM_train`` /
``LSTM_test``) with ``tf.train.load_checkpoint`` and writes the ``{layer:
{param: ndarray}}`` dict, in the JAX layouts, that
``engine/checkpoint.py:load_npy_pretrained`` loads (the train CLI's
``--pre_train OUT``, with ``ignore_missing``); ``OUT`` defaults to
``CKPT.npy``. The names map as :func:`map_variable` says: ``{conv}/weights``
-> ``{conv}/kernel`` (HWIO on both sides), ``{conv}/biases``, the batch
norm's ``gamma`` / ``beta`` under ``{conv}/{conv}/`` (or ``{conv}/BatchNorm/``)
-> ``bn_gamma`` / ``bn_beta``, the BiLSTM's
``{scope}/bidirectional_rnn/{fw,bw}/lstm_cell/{kernel,bias}`` ->
``{scope}/cells/{fw,bw}/{kernel,bias}`` (gate order i, j, f, o on both
sides), the projection ``{scope}/weights`` and ``{scope}/biases``. Moving
batch-norm statistics (the reference never uses them) and optimizer slots
are dropped; anything else is reported and skipped.

It needs ``tensorflow``, imported when a checkpoint is read; where it does
not import, the conversion raises ``ImportError`` naming it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ._common import import_tensorflow

_OPT_SLOT_MARKERS = ('/Adam', '/Momentum', '/RMSProp', 'beta1_power',
                     'beta2_power', 'global_step', 'learning_rate', '/lr')


def map_variable(name, shape):
    """TF1 variable name -> ``(path, None)``, ``path`` a tuple of keys into
    the ``.npy`` dict, or ``(None, reason)`` for a variable skipped."""
    if any(m in name for m in _OPT_SLOT_MARKERS):
        return None, 'optimizer slot'
    parts = name.split('/')
    # contrib batch_norm(scope=name) inside variable_scope(name) doubles the
    # scope (conv4_1/conv4_1/gamma); the BatchNorm default scope maps too
    is_bn = ('BatchNorm' in parts) or (
        len(parts) == 3 and parts[0] == parts[1]
        and parts[-1] in ('gamma', 'beta', 'moving_mean', 'moving_variance'))
    if is_bn:
        scope = parts[parts.index('BatchNorm') - 1] if 'BatchNorm' in parts \
            else parts[0]
        leaf = parts[-1]
        if leaf == 'gamma':
            return (scope, 'bn_gamma'), None
        if leaf == 'beta':
            return (scope, 'bn_beta'), None
        if leaf in ('moving_mean', 'moving_variance'):
            return None, 'moving stat (unused: reference BN is is_training=True)'
        return None, 'unrecognized BatchNorm variable'
    if 'bidirectional_rnn' in parts:
        scope = parts[parts.index('bidirectional_rnn') - 1]
        try:
            direction = parts[parts.index('bidirectional_rnn') + 1]
        except IndexError:
            return None, 'malformed bidirectional_rnn name'
        leaf = parts[-1]
        if direction in ('fw', 'bw') and leaf in ('kernel', 'bias'):
            return (scope, 'cells', direction, leaf), None
        return None, 'unrecognized rnn variable'
    if len(parts) == 2 and parts[1] == 'weights':
        if len(shape) == 4:                      # conv kernel, HWIO both sides
            return (parts[0], 'kernel'), None
        if len(shape) == 2:                      # dense projection
            return (parts[0], 'weights'), None
        return None, 'weights of unsupported rank {}'.format(len(shape))
    if len(parts) == 2 and parts[1] == 'biases':
        return (parts[0], 'biases'), None
    return None, 'unrecognized variable'


def convert_tf_checkpoint(ckpt_path: str, out_path: str) -> dict:
    """Read the checkpoint at ``ckpt_path`` (a prefix, without ``.index``),
    save the mapped dict to ``out_path`` (unless it is empty or None) and
    return it."""
    tf = import_tensorflow('lstm_ctc_ocr_torch.tools.import_tf_checkpoint')
    reader = tf.train.load_checkpoint(ckpt_path)
    shape_map = reader.get_variable_to_shape_map()
    tree = {}
    n_mapped = 0
    for name in sorted(shape_map):
        path, reason = map_variable(name, shape_map[name])
        if path is None:
            if reason != 'optimizer slot':
                print('skipping {}: {}'.format(name, reason))
            continue
        d = tree
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = np.asarray(reader.get_tensor(name))
        n_mapped += 1
    if out_path:
        np.save(out_path, tree, allow_pickle=True)
    print('mapped {} of {} checkpoint variables'.format(
        n_mapped, len(shape_map)))
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Convert a reference TF1 checkpoint to a --pre_train .npy')
    ap.add_argument('ckpt', help='TF checkpoint prefix (no .index/.data '
                                 'suffix)')
    ap.add_argument('--out', default=None,
                    help='output .npy path (default: <ckpt>.npy)')
    args = ap.parse_args(argv)
    out = args.out or (args.ckpt + '.npy')
    convert_tf_checkpoint(args.ckpt, out)
    print('wrote {}'.format(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
