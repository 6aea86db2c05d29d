"""Serialized record dataset (counterpart of the JAX package's
``data/records.py``, same binary format byte for byte, so either package
reads the other's file).

The writer walks an image directory, parses the label from each
``{idx}_{label}.png`` filename and serializes (label, grayscale image)
pairs; the reader streams shuffled, width-bucketed batches. The container
is length-prefixed records over mmap with a trailing index, O(1) random
access::

    [magic 'LCOR'][u32 version]
    per record: [u32 payload_len][payload]
    payload: [u16 label_len][label ascii][u16 h][u16 w][h*w uint8 pixels]
    trailer:  [u64 offsets[n]][u64 n][magic 'XIDX']

Images are stored at their native size; the height-32 resize and the
bucket padding happen at batch time (``data/gen.py:bucket_batch``). PNGs
are read with the port's own decoder (``data/image.py``), which gives the
pixels OpenCV gives.

Write a records file from an image directory::

    python -m lstm_ctc_ocr_torch.data.records data/val out.records
"""

from __future__ import annotations

import mmap
import os
import re
import struct
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .gen import DeviceBatch, bucket_batch, resize_keep_aspect
from .image import load_image

MAGIC = b'LCOR'
IDX_MAGIC = b'XIDX'
VERSION = 1

_LABEL_RE = re.compile(r'^\d+_([0-9a-zA-Z]+)\.(png|jpg|jpeg|bmp)$',
                       re.IGNORECASE)


def parse_label_from_filename(fname: str) -> Optional[str]:
    """``{idx}_{label}.png`` -> label, or None for any other name."""
    m = _LABEL_RE.match(os.path.basename(fname))
    return m.group(1) if m else None


class RecordsWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, 'wb')
        self._f.write(MAGIC)
        self._f.write(struct.pack('<I', VERSION))
        self._offsets: List[int] = []

    def add(self, label: str, image: np.ndarray) -> None:
        assert image.dtype == np.uint8 and image.ndim == 2, \
            'records store grayscale uint8 images'
        lab = label.encode('ascii')
        h, w = image.shape
        payload = struct.pack('<H', len(lab)) + lab + \
            struct.pack('<HH', h, w) + image.tobytes()
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack('<I', len(payload)))
        self._f.write(payload)

    def close(self) -> None:
        for off in self._offsets:
            self._f.write(struct.pack('<Q', off))
        self._f.write(struct.pack('<Q', len(self._offsets)))
        self._f.write(IDX_MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_labeled_images(img_dir: str):
    """Yield (label, grayscale uint8 image) for every ``{idx}_{label}.png``
    in ``img_dir``, in sorted filename order. Only PNG files are decoded
    (``data/image.py``); another extension raises."""
    for fname in sorted(os.listdir(img_dir)):
        label = parse_label_from_filename(fname)
        if label is None:
            continue
        yield label, load_image(os.path.join(img_dir, fname))


def write_image_annotation_pairs_to_records(img_dir: str, out_path: str) -> int:
    """Walk ``img_dir``, parse filename labels, write a records file.
    Returns the number of records written."""
    n = 0
    with RecordsWriter(out_path) as w:
        for label, img in iter_labeled_images(img_dir):
            w.add(label, img)
            n += 1
    return n


class RecordsDataset:
    """mmap-backed random-access reader.

    ``cache_resized`` keeps each image's model-height resize from its first
    use (about IMG_HEIGHT * mean width bytes per example)."""

    def __init__(self, path: str, cfg, cache_resized: bool = True):
        self.path = path
        self.cfg = cfg
        self._resized = {} if cache_resized else None
        self._file = open(path, 'rb')
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        assert self._mm[:4] == MAGIC, 'not a records file: {}'.format(path)
        (version,) = struct.unpack_from('<I', self._mm, 4)
        assert version == VERSION, 'records version {} unsupported'.format(version)
        assert self._mm[-4:] == IDX_MAGIC, 'records file missing index trailer'
        (n,) = struct.unpack_from('<Q', self._mm, len(self._mm) - 12)
        idx_start = len(self._mm) - 12 - 8 * n
        # copy out of the mmap so no exported buffers pin it open
        self._offsets = np.array(np.frombuffer(self._mm, np.uint64, count=n,
                                               offset=idx_start))

    def __len__(self) -> int:
        return len(self._offsets)

    def get(self, i: int) -> Tuple[str, np.ndarray]:
        p = int(self._offsets[i]) + 4
        (lab_len,) = struct.unpack_from('<H', self._mm, p)
        p += 2
        label = self._mm[p:p + lab_len].decode('ascii')
        p += lab_len
        h, w = struct.unpack_from('<HH', self._mm, p)
        p += 4
        img = np.array(np.frombuffer(self._mm, np.uint8, count=h * w,
                                     offset=p)).reshape(h, w)
        return label, img

    def get_at_model_height(self, i: int) -> Tuple[str, np.ndarray]:
        """(label, image resized to cfg.IMG_HEIGHT), cached when enabled."""
        if self._resized is not None and i in self._resized:
            return self._resized[i]
        label, img = self.get(i)
        if img.shape[0] != int(self.cfg.IMG_HEIGHT):
            img = resize_keep_aspect(img, int(self.cfg.IMG_HEIGHT))
        if self._resized is not None:
            self._resized[i] = (label, img)
        return label, img

    def batch(self, indices) -> DeviceBatch:
        """The bucketed batch of the given record indices, in that order."""
        pairs = [self.get_at_model_height(int(i)) for i in indices]
        return bucket_batch([im for _, im in pairs],
                            [lab for lab, _ in pairs], self.cfg)

    def batch_iterator(self, batch_size: int, shuffle: bool = True,
                       seed: int = 0, epochs: Optional[int] = None
                       ) -> Iterator[DeviceBatch]:
        """Shuffled width-bucketed DeviceBatch stream; the same seed gives
        the JAX package's order (numpy ``RandomState.permutation``)."""
        rng = np.random.RandomState(seed)
        n = len(self)
        assert n >= batch_size, 'dataset smaller than one batch'
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n - batch_size + 1, batch_size):
                yield self.batch(order[start:start + batch_size])
            epoch += 1

    def close(self):
        self._mm.close()
        self._file.close()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print('usage: python -m lstm_ctc_ocr_torch.data.records IMG_DIR '
              'OUT.records', file=sys.stderr)
        return 2
    n = write_image_annotation_pairs_to_records(argv[0], argv[1])
    print('wrote {} records to {}'.format(n, argv[1]))
    return 0 if n else 1


if __name__ == '__main__':
    sys.exit(main())
