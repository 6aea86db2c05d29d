"""Build a records dataset (``data/records.py``) from a directory of labeled
images, or render one straight into the file.

Counterpart of the JAX package's ``tools/build_records.py``, with its
command line::

    python -m lstm_ctc_ocr_torch.tools.build_records --img_dir DIR \\
        [--out OUT]
    python -m lstm_ctc_ocr_torch.tools.build_records --synth N [--seed S] \\
        [--out OUT] [--cfg YML] [--set KEY VALUE ...]

``--img_dir`` walks ``{idx}_{label}.png`` files; ``--synth N`` renders N
lines of the synthetic stream (``data/gen.py:generate_img``, the
``--cfg`` / ``--set`` config's lengths, charset and renderer; ``RENDERER
native`` needs no Pillow) from ``random.Random(seed)`` with no intermediate
PNGs, the same records as the JAX tool's from the same seed. The file is
the JAX package's format byte for byte.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from ..config import load_cfg
from ..data.gen import generate_img
from ..data.records import (RecordsWriter,
                            write_image_annotation_pairs_to_records)


def synth_to_records(cfg, n: int, out_path: str, seed: int = 0) -> int:
    """Render ``n`` lines from ``random.Random(seed)`` into ``out_path``."""
    rng = random.Random(seed)
    with RecordsWriter(out_path) as w:
        for i in range(n):
            img, label = generate_img(cfg, rng)
            w.add(label, np.asarray(img, dtype=np.uint8))
            if (i + 1) % 5000 == 0:
                print('  {}/{}'.format(i + 1, n), flush=True)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--img_dir', default=None,
                    help='directory of {idx}_{label}.png images')
    ap.add_argument('--out', default='./data/train_4_6.records')
    ap.add_argument('--synth', type=int, default=None,
                    help='render N lines directly instead of reading a dir')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--cfg', default=None,
                    help='experiment yml: --synth renders with ITS length/'
                         'charset/renderer (e.g. lstm/longline.yml)')
    ap.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                    default=None, help='config overrides')
    args = ap.parse_args(argv)
    if args.synth:
        n = synth_to_records(load_cfg(args.cfg, args.set_cfgs or ()),
                             args.synth, args.out, args.seed)
    else:
        if not args.img_dir:
            ap.error('need --img_dir or --synth N')
        n = write_image_annotation_pairs_to_records(args.img_dir, args.out)
    print('wrote {} records to {}'.format(n, args.out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
