"""Export a dataset to reference-format TFRecord SequenceExamples.

Counterpart of the JAX package's ``tools/export_tfrecords.py``, with its
command line, functions and output::

    python -m lstm_ctc_ocr_torch.tools.export_tfrecords SRC --out OUT.tfrecords

``SRC`` is a records file (``data/records.py``) or a directory of
``{idx}_{label}.png`` images. The file is what the reference's dev-branch
reader takes, and the JAX tool's bytes: context int64 features ``height``
/ ``width`` / ``time_step`` / ``label_len`` and ``image_raw`` (raw uint8
pixels), a ``label`` int64 feature list padded with 0 to MAX_CHAR_LEN, with
the reference writer's two quirks: ``time_step`` is ``IMG_SHAPE[0]`` of the
default config whatever the image, and gray pixels are stored as RGB, the
gray value in all three channels, because the reference reader reshapes
to ``[h, w, 3]``. The luma weights of ``tools/import_tfrecords.py`` sum to
one, so export then import gives back the gray image exactly. Labels
longer than MAX_CHAR_LEN or with characters outside the charset are
reported and skipped.

It needs ``tensorflow``, imported when a file is written; where it does not
import, the export raises ``ImportError`` naming it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import default_cfg, get_encode_decode_dict
from ..data.records import RecordsDataset, iter_labeled_images
from ._common import import_tensorflow

_TOOL = 'lstm_ctc_ocr_torch.tools.export_tfrecords'


def iter_dataset(src):
    """Yield (label, uint8 image) from a records file or an image
    directory."""
    if os.path.isdir(src):
        yield from iter_labeled_images(src)
    else:
        ds = RecordsDataset(src, default_cfg())
        try:
            for i in range(len(ds)):
                yield ds.get(i)
        finally:
            ds.close()


def make_sequence_example(label: str, image: np.ndarray, encode_maps,
                          max_char_len: int, time_step: int):
    """One reference-schema ``tf.train.SequenceExample``."""
    tf = import_tensorflow(_TOOL)
    if image.ndim == 2:                  # the reference reader wants [h,w,3]
        image = np.repeat(image[:, :, None], 3, axis=2)
    ids = [encode_maps[c] for c in label]
    padded = ids + [0] * (max_char_len - len(ids))

    def i64(v):
        return tf.train.Feature(int64_list=tf.train.Int64List(value=[v]))

    context = tf.train.Features(feature={
        'height': i64(image.shape[0]),
        'width': i64(image.shape[1]),
        'time_step': i64(time_step),
        'label_len': i64(len(ids)),
        'image_raw': tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[image.tobytes()])),
    })
    labels = tf.train.FeatureList(feature=[i64(v) for v in padded])
    return tf.train.SequenceExample(
        context=context,
        feature_lists=tf.train.FeatureLists(feature_list={'label': labels}))


def export_tfrecords(src: str, out_path: str) -> int:
    """Write the examples of ``src`` to ``out_path`` under the default
    config's charset, MAX_CHAR_LEN and IMG_SHAPE; returns the number
    written."""
    tf = import_tensorflow(_TOOL)
    cfg = default_cfg()
    encode_maps, _ = get_encode_decode_dict(cfg)
    max_char_len, time_step = int(cfg.MAX_CHAR_LEN), int(cfg.IMG_SHAPE[0])
    n = 0
    with tf.io.TFRecordWriter(out_path) as w:
        for label, img in iter_dataset(src):
            if len(label) > max_char_len:
                print('skipping {}-char label {!r}: exceeds MAX_CHAR_LEN={}'
                      .format(len(label), label, max_char_len))
                continue
            bad = [c for c in label if c not in encode_maps]
            if bad:
                print('skipping label {!r}: chars {} not in CHARSET'
                      .format(label, bad))
                continue
            ex = make_sequence_example(label, img, encode_maps, max_char_len,
                                       time_step)
            w.write(ex.SerializeToString())
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Export a records file or image dir to reference-format '
                    'TFRecords')
    ap.add_argument('src', help='.records file or image directory')
    ap.add_argument('--out', required=True, help='output .tfrecords path')
    args = ap.parse_args(argv)
    n = export_tfrecords(args.src, args.out)
    print('exported {} records from {} -> {}'.format(n, args.src, args.out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
