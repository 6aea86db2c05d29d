"""Import reference-format TFRecord files into the records container.

Counterpart of the JAX package's ``tools/import_tfrecords.py``, with its
command line, functions and output::

    python -m lstm_ctc_ocr_torch.tools.import_tfrecords IN.tfrecords \\
        --out OUT.records

The reference's dev branch stores its dataset as TFRecord SequenceExamples:
context features ``height`` / ``width`` / ``time_step`` / ``label_len``
(int64) and ``image_raw`` (raw uint8 pixels), and a ``label`` int64 feature
list padded with 0 to MAX_CHAR_LEN. Each record is decoded with the TF
protobuf classes alone, its ids mapped back to characters through the
charset codec of the default config, an RGB(A) image turned gray by the
luma weights (a gray + alpha one keeps its gray channel), and written to
the records file (``data/records.py``, the JAX package's format byte for
byte) that ``DATA_BACKEND records`` reads. Records whose ids are not in the
charset, or whose label is empty or longer than ``max(MAX_LEN,
MAX_CHAR_LEN)``, are reported and skipped.

It needs ``tensorflow``, imported when a file is read; where it does not
import, the import raises ``ImportError`` naming it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import default_cfg, get_encode_decode_dict
from ..data.gen import max_label_len
from ..data.records import RecordsWriter
from ._common import import_tensorflow


def iter_sequence_examples(path):
    """Yield the ``tf.train.SequenceExample``s of a TFRecord file."""
    tf = import_tensorflow('lstm_ctc_ocr_torch.tools.import_tfrecords')
    for raw in tf.data.TFRecordDataset(path).as_numpy_iterator():
        yield tf.train.SequenceExample.FromString(raw)


def decode_example(ex, decode_maps):
    """SequenceExample -> (label string, grayscale uint8 image)."""
    ctx = ex.context.feature
    h = int(ctx['height'].int64_list.value[0])
    w = int(ctx['width'].int64_list.value[0])
    label_len = int(ctx['label_len'].int64_list.value[0])
    raw = ctx['image_raw'].bytes_list.value[0]
    c = len(raw) // (h * w)
    img = np.frombuffer(raw, np.uint8).reshape(
        (h, w) if c == 1 else (h, w, c))
    if img.ndim == 3:       # the reference stores RGB
        if img.shape[2] == 2:          # gray + alpha: the gray channel
            img = np.ascontiguousarray(img[..., 0])
        else:                          # RGB / RGBA (alpha ignored)
            img = np.round(
                0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2]).astype(np.uint8)
    ids = [int(v) for f in ex.feature_lists.feature_list['label'].feature
           for v in f.int64_list.value]
    label = ''.join(decode_maps[i] for i in ids[:label_len])
    return label, img


def import_tfrecords(tfrecord_path: str, out_path: str) -> int:
    """Convert ``tfrecord_path`` into the records file ``out_path`` under
    the default config's charset and label length; returns the number of
    records written."""
    cfg = default_cfg()
    _, decode_maps = get_encode_decode_dict(cfg)
    l_max = max_label_len(cfg)
    n = i = skipped = 0
    with RecordsWriter(out_path) as w:
        for i, ex in enumerate(iter_sequence_examples(tfrecord_path), 1):
            # checked here, not deep inside a training run: the reference
            # writer emits labels longer than its maxLen, unpadded
            try:
                label, img = decode_example(ex, decode_maps)
            except KeyError as e:
                skipped += 1
                print('skipping record {}: label id {} not in charset'
                      .format(i, e))
                continue
            if not label or len(label) > l_max:
                skipped += 1
                print('skipping record {}: {}-char label {!r} outside '
                      '(1..MAX_CHAR_LEN={})'.format(i, len(label), label,
                                                    l_max))
                continue
            w.add(label, img)
            n += 1
    if skipped:
        print('skipped {} of {} records'.format(skipped, i))
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Convert reference-format TFRecords to native records')
    ap.add_argument('tfrecords', help='input .tfrecords file (reference '
                                      'dev-branch format)')
    ap.add_argument('--out', required=True, help='output .records path')
    args = ap.parse_args(argv)
    n = import_tfrecords(args.tfrecords, args.out)
    print('imported {} records from {} -> {}'.format(n, args.tfrecords,
                                                     args.out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
