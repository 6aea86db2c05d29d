"""Promote the newest training snapshot to a tracked release checkpoint.

Counterpart of the JAX package's ``tools/release_ckpt.py``::

    python -m lstm_ctc_ocr_torch.tools.release_ckpt --cfg lstm/lstm.yml \
        [--step N] [--f32] [--verify-dir data/val --batch 64] \
        [--device cuda] [--set KEY VALUE ...]

Training snapshots (``output/<EXP_DIR>/``, params + optimizer state) are
not tracked; releases (``checkpoints/<EXP_DIR>/``) are, and are what eval
falls back to on a fresh clone. The snapshot is restored into the
``LSTM_test`` network and written by ``engine/checkpoint.py:save_release``:
the params only, float leaves in f16 (``--f32`` keeps f32), and the moving
BN statistics in f32 when the snapshot has them — the JAX tool's file,
readable by either package. With ``--verify-dir`` the tool re-evaluates the
RELEASED file on that labelled directory (on ``--device``, CUDA by
default) and prints its accuracy, so the number recorded for a release is
measured on exactly the file that ships. ``--set ROOT_DIR <dir>`` puts
both ``output/`` and ``checkpoints/`` under another root.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import get_output_dir, load_cfg
from ..engine import checkpoint
from ..engine.test import test_net
from ..models.factory import get_network


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Release a trained checkpoint')
    p.add_argument('--cfg', required=True, help='experiment yml')
    p.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                   help='dotted-path config overrides: KEY VALUE ...')
    p.add_argument('--step', type=int, default=None,
                   help='snapshot step (default: newest)')
    p.add_argument('--f32', action='store_true',
                   help='keep float32 leaves (default: store f16)')
    p.add_argument('--verify-dir', default=None,
                   help='labeled image dir; re-evaluate the released file')
    p.add_argument('--batch', type=int, default=64,
                   help='eval batch size for --verify-dir')
    p.add_argument('--device', default='cuda',
                   help="device of --verify-dir's eval: 'cuda' (default) or "
                        "'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cfg(args.cfg, args.set_cfgs)
    out_dir = get_output_dir(cfg)
    ckpts = checkpoint.list_checkpoints(out_dir)
    if not ckpts:
        raise SystemExit('no snapshots in {}'.format(out_dir))
    if args.step is not None:
        match = [c for c in ckpts if c[1] == args.step]
        if not match:
            raise SystemExit('no snapshot at step {} (have {})'.format(
                args.step, sorted(s for _, s in ckpts)))
        path, step = match[0]
    else:
        path, step = max(ckpts, key=lambda x: x[1])

    keys = checkpoint.read_flat(path).keys()
    if not any(k.startswith('params/') for k in keys):
        raise SystemExit('snapshot {} has no params/ leaves'.format(path))
    # moving BN statistics ship inside the release when the snapshot has
    # them, so BN_EVAL=moving eval works from a fresh clone
    with_bn = any(k.startswith('bn_state/') for k in keys)
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, path, need_bn_state=False)
    rel = checkpoint.save_release(model, out_dir, step, cfg,
                                  dtype=None if args.f32 else 'float16',
                                  with_bn_state=with_bn)
    if with_bn:
        print('release carries moving BN statistics (BN_EVAL=moving ready)')
    size_mb = os.path.getsize(rel) / 1e6
    print('released {} ({} MB, step {})'.format(rel, round(size_mb, 1), step))

    if args.verify_dir:
        # evaluate the released file itself: the release dir is the eval's
        # checkpoint dir, so the f16 file that ships is what gets restored
        rel_dir = checkpoint.release_dir(out_dir)
        newest = checkpoint.latest_checkpoint(rel_dir)
        if newest is None \
                or os.path.abspath(newest[0]) != os.path.abspath(rel):
            raise SystemExit(
                'release dir {} would restore {} instead of the file just '
                'released ({}); remove stale higher-step releases before '
                'verifying'.format(rel_dir, newest and newest[0], rel))
        cfg.TEST.BATCH_SIZE = args.batch
        r = test_net(cfg, args.verify_dir, rel_dir, device=args.device)
        print('released-weights accuracy: {:.4f} ({}/{}, p50 decode {:.4f}s)'
              .format(r.acc, r.correct, r.total, r.p50))
    return 0


if __name__ == '__main__':
    sys.exit(main())
