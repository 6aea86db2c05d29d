"""Offline labeled dataset writer: the port's counterpart of the JAX
package's ``data/gen_img.py``.

Writes ``{index:08d}_{label}.png`` files into a directory, the
filename-encoded label format that the eval entry point (``engine/test.py``)
and the records writer (``data/records.py``) read. Image ``ind`` draws its
label and pixels from ``random.Random(ind * 9176 + 11)``, so a file
depends on its index alone, whatever the worker count, and the same
``cfg`` gives the JAX package's files. The renderer is ``cfg.RENDERER``'s
(``native`` needs no Pillow); PNGs are written by ``data/image.py``'s
encoder. Run::

    python -m lstm_ctc_ocr_torch.data.gen_img [NUM] [OUT_DIR] \\
        [--workers N] [--cfg YML] [--set KEY VALUE ...]

``run`` fans out over ``multiprocessing.Pool(workers)`` (``cpu_count() - 1``
by default) and renders inline at ``workers <= 1``.
"""

from __future__ import annotations

import argparse
import functools
import os
import random
import sys
from multiprocessing import Pool, cpu_count

from ..config import default_cfg, load_cfg
from .gen import _renderer, gen_rand


def generate_one(ind: int, out_dir: str = './data/val', cfg=None) -> str:
    """Render image ``ind`` into ``out_dir``; returns its path. ``out_dir``
    and ``cfg`` travel as arguments, not module state: under the spawn
    start method a worker imports this module afresh."""
    cfg = default_cfg() if cfg is None else cfg
    rng = random.Random(ind * 9176 + 11)
    chars = gen_rand(cfg, rng)
    path = os.path.join(out_dir, '{:08d}_{}.png'.format(ind, chars))
    _renderer(cfg).write(chars, path, rng=rng)
    return path


def run(num: int, out_dir: str = './data/val', workers: int | None = None,
        cfg=None) -> None:
    """Write images ``0 .. num - 1`` into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    if workers is None:
        workers = max(cpu_count() - 1, 0)
    task = functools.partial(generate_one, out_dir=out_dir,
                             cfg=default_cfg() if cfg is None else cfg)
    if workers <= 1:
        for i in range(num):
            task(i)
    else:
        with Pool(workers) as pool:
            pool.map(task, range(num))
    print('wrote {} images to {}'.format(num, out_dir))


def main(argv=None):
    ap = argparse.ArgumentParser(description='write a labeled PNG dataset')
    ap.add_argument('num', nargs='?', type=int, default=500)
    ap.add_argument('out_dir', nargs='?', default='./data/val')
    ap.add_argument('--workers', type=int, default=None)
    ap.add_argument('--cfg', default=None, help='experiment YAML')
    ap.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                    default=[], help='config overrides: KEY VALUE ...')
    args = ap.parse_args(argv)
    run(args.num, args.out_dir, args.workers,
        load_cfg(args.cfg, args.set_cfgs))
    return 0


if __name__ == '__main__':
    sys.exit(main())
