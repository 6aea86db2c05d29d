"""Estimate moving BN statistics for a checkpoint that has none.

Counterpart of the JAX package's ``tools/calibrate_bn.py``::

    python -m lstm_ctc_ocr_torch.tools.calibrate_bn --cfg lstm/lstm.yml \
        [--release] [--ckpt FILE] [--batches 32] [--batch 64] [--seed 11] \
        [--device cuda] [--set KEY VALUE ...]

``BN_EVAL: moving`` eval needs each batch-norm layer's moving mean and
variance. Training accumulates them (the train step's moving average);
params-only checkpoints and older releases have none. This tool estimates
them after the fact: it streams K batches of the synthetic training
distribution (``data/gen.py:get_batch``, inline, seeded; set ``RENDERER
native`` where Pillow is missing) through the restored network, pools the
per-batch statistics exactly (E[x] and E[x^2] over equal-sized batches, not
a moving average) and writes the result INTO the checkpoint file as
``bn_state/<layer>/{mean,var}`` keys. The file is rewritten atomically with
its params untouched; a file under a ``checkpoints/`` directory (a release)
stays compressed, a training snapshot stays uncompressed, as the JAX tool
keeps them.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch

from ..config import get_output_dir, load_cfg
from ..data.gen import get_batch
from ..engine import checkpoint
from ..engine.test import full_f32, resolve_device
from ..engine.train import compute_dtype
from ..models.factory import get_network
from ..models.layers import ConvSingle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Estimate moving BN statistics')
    p.add_argument('--cfg', required=True, help='experiment yml')
    p.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                   help='dotted-path config overrides: KEY VALUE ...')
    p.add_argument('--ckpt', default=None,
                   help='checkpoint file (default: what eval would restore '
                        '— newest output/ snapshot, else the release)')
    p.add_argument('--release', action='store_true',
                   help='target the tracked release in checkpoints/<EXP_DIR> '
                        'even when output/ has snapshots')
    p.add_argument('--batches', type=int, default=32,
                   help='calibration batches (default 32)')
    p.add_argument('--batch', type=int, default=64,
                   help='calibration batch size (default 64)')
    p.add_argument('--seed', type=int, default=11,
                   help='synth stream seed (disjoint from training/val)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


@full_f32()
def pooled_bn_stats(model, cfg, batches: int, batch: int, seed: int,
                    device) -> Dict[str, Dict[str, np.ndarray]]:
    """``{layer: {'mean', 'var'}}`` (f32 numpy) pooled over ``batches``
    seeded synthetic batches of ``batch`` images: the mean of the batch
    means and E[x^2] - mean^2 (floored at 0), E[x^2] per batch being its
    biased variance plus its mean squared — the JAX tool's arithmetic, in
    f32."""
    names = {m: name for name, m in model.named_modules()
             if isinstance(m, ConvSingle) and m.bn}
    dtype = compute_dtype(cfg)
    sum_mean, sum_sq = {}, {}
    stream = get_batch(cfg, num_workers=0, seed=seed, batch_size=batch,
                       bucketed=True)
    try:
        for _ in range(batches):
            b = next(stream)
            coll = []
            with torch.inference_mode():
                model(torch.from_numpy(b.image).to(device),
                      torch.from_numpy(b.time_step).to(device), dtype=dtype,
                      bn_collect=coll)
            for layer, mean, var in coll:
                mean, var = mean.cpu().numpy(), var.cpu().numpy()
                name = names[layer]
                sq = var + mean ** 2
                if name in sum_mean:
                    sum_mean[name] = sum_mean[name] + mean
                    sum_sq[name] = sum_sq[name] + sq
                else:
                    sum_mean[name], sum_sq[name] = mean, sq
    finally:
        stream.close()
    k = float(batches)
    out = {}
    for name in sorted(sum_mean):
        m = (sum_mean[name] / k).astype(np.float32)
        v = np.maximum((sum_sq[name] / k - m ** 2).astype(np.float32), 0.0)
        out[name] = {'mean': m, 'var': v}
    return out


def write_bn_state(path: str, bn_state: Dict[str, Dict[str, np.ndarray]]):
    """Rewrite the checkpoint at ``path`` with ``bn_state/...`` keys in
    place of any it had; everything else unchanged. Releases (under a
    ``checkpoints`` directory) stay compressed, snapshots uncompressed."""
    out = {k: v for k, v in checkpoint.read_flat(path).items()
           if not k.startswith('bn_state/')}
    for name, stats in bn_state.items():
        for key, arr in stats.items():
            out['bn_state/{}/{}'.format(name, key)] = arr
    compressed = os.sep + 'checkpoints' + os.sep in os.path.abspath(path)
    checkpoint.write_npz(path, out, compressed=compressed)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cfg(args.cfg, args.set_cfgs)
    dev = resolve_device(args.device)
    out_dir = get_output_dir(cfg)
    if args.ckpt:
        path = args.ckpt
    else:
        found = (checkpoint.latest_checkpoint(checkpoint.release_dir(out_dir))
                 if args.release
                 else checkpoint.latest_eval_checkpoint(out_dir))
        if found is None:
            raise SystemExit('no checkpoint for {} (looked in {}{})'.format(
                cfg.EXP_DIR, out_dir,
                '' if args.release else ' and its release dir'))
        path = found[0]
    print('calibrating BN statistics for {}'.format(path))

    model = get_network('LSTM_test', cfg)
    if not any(isinstance(m, ConvSingle) and m.bn for m in model.modules()):
        raise SystemExit('network has no bn=True conv layers: nothing to do')
    checkpoint.load_into(model, path, need_bn_state=False, params_only=True)
    model = model.to(dev).eval()
    bn_state = pooled_bn_stats(model, cfg, args.batches, args.batch,
                               args.seed, dev)
    for name, s in bn_state.items():
        m, v = s['mean'], s['var']
        print('  {:12s} mean [{:+.3f}..{:+.3f}] var [{:.4f}..{:.3f}]'.format(
            name, m.min(), m.max(), v.min(), v.max()))
    write_bn_state(path, bn_state)
    print('wrote {} bn_state layer(s) into {} ({} batches of {}, seed {})'
          .format(len(bn_state), path, args.batches, args.batch, args.seed))
    return 0


if __name__ == '__main__':
    sys.exit(main())
