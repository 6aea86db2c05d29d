"""Benchmark the HOST side of the pipeline: renderers and data backends.

Counterpart of the JAX package's ``tools/bench_data.py``, with its flags,
defaults and output lines. The step rate assumes batches already in host
memory; on a host with few cores the renderer and the backend are what
bound sustained training. One JSON line per measurement:

* each renderer of ``--renderers``: images/s of ``data/gen.generate_img``
  brought to the model height (equal work: the native renderer resizes in
  C++, the Pillow ones here), or an error line where it cannot run (a
  renderer that needs Pillow, on a machine without it);
* each backend of ``--backends``: steady batches/s and images/s of the
  training stream (``synth``: ``get_batch`` with
  ``effective_workers(TRAIN.NUM_WORKERS)`` workers; ``pool``: a
  ``--pool-size`` pool with ``POOL_REFRESH`` renders a batch; ``records``:
  ``RECORDS_PATH`` after one epoch has filled its resize cache).

The JAX tool renders the backends with ``captcha``, which needs Pillow. The
port keeps ``captcha`` where ``--renderers`` lists it, and otherwise uses
the first renderer listed, so that ``--renderers native`` measures the
``synth`` and ``pool`` backends on a machine without Pillow. Nothing here
runs on the card; ``--device`` is checked as every tool's is. Run::

    python -m lstm_ctc_ocr_torch.tools.bench_data [--renderers native]
        [--device cpu] [--set RECORDS_PATH data/val.records ...]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

from ..config import load_cfg
from ..data.gen import generate_img, get_batch, resize_keep_aspect
from ..engine.test import resolve_device
from ..engine.train import effective_workers


def bench_renderer(cfg, name: str, n: int) -> dict:
    cfg.RENDERER = name
    rng = random.Random(0)

    def render():
        img, _ = generate_img(cfg, rng)
        if img.shape[0] != int(cfg.IMG_HEIGHT):
            img = resize_keep_aspect(img, int(cfg.IMG_HEIGHT))
        return img

    render()                                   # warm the font/atlas caches
    t0 = time.perf_counter()
    for _ in range(n):
        render()
    dt = time.perf_counter() - t0
    return {'renderer': name, 'img_per_sec': round(n / dt, 1)}


def bench_backend(cfg, name: str, batch: int, n_batches: int) -> dict:
    seed = int(cfg.RNG_SEED)
    n_examples = 0
    if name == 'records':
        from ..data.records import RecordsDataset
        path = str(cfg.RECORDS_PATH)
        if not os.path.exists(path):
            return {'backend': name, 'skipped': 'no records file at ' + path}
        ds = RecordsDataset(path, cfg)
        n_examples = len(ds)
        stream = ds.batch_iterator(batch, shuffle=True, seed=seed)
    elif name == 'pool':
        from ..data.pool import PoolSampler
        stream = PoolSampler(cfg, int(cfg.POOL_SIZE), seed=seed,
                             verbose=False).batch_iterator(batch)
    else:
        workers = effective_workers(int(cfg.TRAIN.NUM_WORKERS))
        stream = get_batch(cfg, num_workers=workers, seed=seed,
                           batch_size=batch, bucketed=True)
    # records: one full epoch fills the resized-image cache; training runs
    # many epochs over a fixed set, so the steady state is the real rate
    warm = (n_examples // batch + 2) if name == 'records' else 3
    warm_truncated = warm > 4000               # huge dataset: partly cold
    try:
        for _ in range(min(warm, 4000)):
            next(stream)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(stream)
        dt = time.perf_counter() - t0
    finally:
        close = getattr(stream, 'close', None)
        if close:
            close()
    out = {'backend': name, 'batch': batch,
           'batches_per_sec': round(n_batches / dt, 2),
           'img_per_sec': round(n_batches * batch / dt, 1)}
    if warm_truncated:
        out['warm_truncated'] = True   # cache not fully warm: NOT steady
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--batches', type=int, default=20,
                    help='timed batches per backend')
    ap.add_argument('--images', type=int, default=100,
                    help='timed renders per renderer')
    ap.add_argument('--renderers', default='captcha,native')
    ap.add_argument('--backends', default='synth,pool,records')
    ap.add_argument('--pool-size', type=int, default=2000,
                    help='pool backend size (start-up cost only; the steady '
                         'rate is set by POOL_REFRESH renders per batch)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                    help='config overrides: KEY VALUE ...')
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = load_cfg(None, args.set_cfgs)

    renderers = [r.strip() for r in args.renderers.split(',')]
    for r in renderers:
        try:
            print(json.dumps(bench_renderer(cfg, r, args.images)),
                  flush=True)
        except Exception as e:       # a renderer that cannot run: its line
            print(json.dumps({'renderer': r, 'error': str(e)}), flush=True)
    cfg.RENDERER = 'captcha' if 'captcha' in renderers else renderers[0]
    cfg.POOL_SIZE = args.pool_size
    for b in args.backends.split(','):
        try:
            print(json.dumps(bench_backend(cfg, b.strip(), args.batch,
                                           args.batches)), flush=True)
        except Exception as e:       # a backend that cannot run: its line
            print(json.dumps({'backend': b.strip(), 'error': str(e)}),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
