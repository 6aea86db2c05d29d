"""Export a trained checkpoint as serving artifacts (``torch.export``).

Counterpart of the JAX package's ``tools/export_model.py``. Freezes the
checkpoint eval would restore (newest ``output/<EXP_DIR>/`` snapshot, else
the release in ``checkpoints/<EXP_DIR>/``) into one decode program per
width bucket (``engine/serve.py``), so a server runs inference without the
checkpoint or the config, and never traces per shape::

    python -m lstm_ctc_ocr_torch.tools.export_model --cfg lstm/lstm.yml \
        [--out output/lstm_ctc/export] [--buckets 96,128] [--batch 64] \
        [--device cuda] [--check] [--set KEY VALUE ...]

The programs run on the device they were exported for (``--device``, CUDA
by default; without CUDA it raises). Loading them needs
``lstm_ctc_ocr_torch`` importable: they call its kernels as custom ops.
``--check`` reloads each artifact and holds its ids equal to the live
decode on random inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..config import get_output_dir, load_cfg
from ..engine import checkpoint
from ..engine.serve import ExportedDecoder, export_decoder
from ..engine.test import full_f32, make_decode_step
from ..models.factory import get_network


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Export serving artifacts')
    ap.add_argument('--cfg', default='lstm/lstm.yml')
    ap.add_argument('--network', default='LSTM_test')
    ap.add_argument('--out', default=None,
                    help='artifact dir (default output/<EXP_DIR>/export)')
    ap.add_argument('--buckets', default=None,
                    help='comma-separated widths (default cfg.BUCKETS)')
    ap.add_argument('--batch', type=int, default=None,
                    help='serving batch per program (default TEST.BATCH_SIZE)')
    ap.add_argument('--device', default='cuda',
                    help="device the programs run on: 'cuda' (default) or "
                         "'cpu'")
    ap.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                    help='dotted-path config overrides: KEY VALUE ...')
    ap.add_argument('--check', action='store_true',
                    help='hold each artifact to the live decode')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cfg(args.cfg, args.set_cfgs)
    out_dir = get_output_dir(cfg)
    export_dir = args.out or os.path.join(out_dir, 'export')
    buckets = ([int(b) for b in args.buckets.split(',')]
               if args.buckets else None)

    net = get_network(args.network, cfg)
    found = checkpoint.latest_eval_checkpoint(out_dir)
    if found is None:
        raise SystemExit('no checkpoint in {} (nor a release in {})'.format(
            out_dir, checkpoint.release_dir(out_dir)))
    path, step = found
    # under BN_EVAL=moving a file without bn_state raises here
    checkpoint.load_into(net, path, str(cfg.BN_EVAL) == 'moving')
    print('freezing {} (step {})'.format(path, step))

    manifest = export_decoder(net, cfg, export_dir, buckets=buckets,
                              batch=args.batch, device=args.device)
    sizes = {f: os.path.getsize(os.path.join(export_dir, f)) // 1024
             for f in sorted(os.listdir(export_dir))}
    print(json.dumps({'export_dir': export_dir, 'kib': sizes,
                      'buckets': manifest['buckets'],
                      'batch': manifest['batch'],
                      'export_seconds': manifest['export_seconds']}))

    if args.check:
        live = make_decode_step(net, cfg, args.device)
        dec = ExportedDecoder(export_dir, device=args.device)
        rng = np.random.RandomState(0)
        for w in manifest['buckets']:
            img = rng.rand(manifest['batch'], w,
                           int(cfg.NUM_FEATURES)).astype(np.float32)
            ts = np.full((manifest['batch'],), w // int(cfg.POOL_SCALE)
                         + int(cfg.OFFSET_TIME_STEP), np.int32)
            with full_f32():
                want = live(img, ts)
            got = dec.run(img, ts)
            if not np.array_equal(got, want):
                raise SystemExit(
                    'bucket {}: artifact != live decode'.format(w))
            print('bucket {}: artifact == live decode'.format(w))
    return 0


if __name__ == '__main__':
    sys.exit(main())
