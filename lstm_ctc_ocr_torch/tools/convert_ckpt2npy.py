"""Dump the model weights of a checkpoint to a plain ``.npy`` dict.

Counterpart of the JAX package's ``tools/convert_ckpt2npy.py``, with the
same command line and the same dict::

    python -m lstm_ctc_ocr_torch.tools.convert_ckpt2npy CKPT [--out OUT]

It reads a ``*_iter_N.ckpt.npz`` (either package's: they share the flat
format, ``engine/checkpoint.py``) and saves its ``params/`` leaves as
``{layer: {param: ndarray}}``, nested as the keys are (a stacked ``lstm``
layer's cells under digit keys), in the JAX layouts and dtypes as stored;
``OUT`` defaults to the checkpoint's path with ``.npy`` for its last
suffix. Load it with ``np.load(path, allow_pickle=True).item()``, or warm
start from it with ``engine.train``'s ``--pre_train OUT``
(``checkpoint.load_npy_pretrained``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def convert(ckpt_path: str, out_path: str) -> dict:
    """Write the ``.npy`` dict of ``ckpt_path`` to ``out_path``; return it."""
    with np.load(ckpt_path) as data:
        flat = {k: data[k] for k in data.files if k.startswith('params/')}
    tree = {}
    for key, arr in flat.items():
        parts = key.split('/')[1:]   # drop 'params'
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    np.save(out_path, tree, allow_pickle=True)
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('ckpt', help='path to *_iter_N.ckpt.npz')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    out = args.out or (os.path.splitext(args.ckpt)[0] + '.npy')
    tree = convert(args.ckpt, out)
    print('wrote {} ({} layers)'.format(out, len(tree)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
