"""Width buckets and fixed-shape batches (counterpart of ``pick_bucket``,
``DeviceBatch``, ``max_label_len`` and ``bucket_batch`` in the JAX package's
``data/gen.py``; the synthetic captcha stream is not ported yet).

``bucket_batch`` resizes every image to the model height (aspect kept,
``data/image.py:resize_linear``), right-pads the width to one bucket, lays
the pixels out width-major and encodes the labels densely, so that every
batch of a bucket has one static shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..config import get_encode_decode_dict
from .image import resize_linear


def pick_bucket(width: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= width; doubles the largest bucket past its end."""
    for b in buckets:
        if b >= width:
            return int(b)
    b = int(buckets[-1])
    while b < width:
        b *= 2
    return b


@dataclass
class DeviceBatch:
    """A fixed-shape batch ready for the host->device copy.

    image:      [N, W_bucket, 32] width-major, zero right-pad. uint8 raw
                pixels under ``TRANSFER_DTYPE: uint8`` (the model divides by
                255 on the device), else float32 already /255.
    label:      int32   [N, L_max]          dense labels, 0-padded
    label_len:  int32   [N]
    time_step:  int32   [N]                 valid frames = resized W//4 - 1
    """
    image: np.ndarray
    label: np.ndarray
    label_len: np.ndarray
    time_step: np.ndarray

    @property
    def flat_labels(self) -> np.ndarray:
        """warp-ctc style flat label vector."""
        return np.concatenate([self.label[i, :n]
                               for i, n in enumerate(self.label_len)]) \
            if len(self.label_len) else np.zeros((0,), np.int32)


def max_label_len(cfg) -> int:
    return max(int(cfg.MAX_LEN), int(cfg.MAX_CHAR_LEN))


def resize_keep_aspect(img: np.ndarray, nh: int) -> np.ndarray:
    """Resize to height ``nh`` preserving the aspect ratio."""
    h, w = img.shape[:2]
    return resize_linear(img, int(nh / h * w), nh)


def bucket_batch(imgs: List[np.ndarray], labels: List[str], cfg,
                 buckets: Sequence[int] = None) -> DeviceBatch:
    """Batch with a static bucketed width and dense labels."""
    encode_maps, _ = get_encode_decode_dict(cfg)
    nh = int(cfg.IMG_HEIGHT)
    # images already at the model height (the records reader caches resized
    # ones) skip the per-batch resize
    resized = [img if img.shape[0] == nh else resize_keep_aspect(img, nh)
               for img in imgs]
    widths = [im.shape[1] for im in resized]
    w_bucket = pick_bucket(max(widths),
                           buckets if buckets is not None else cfg.BUCKETS)
    n = len(imgs)
    l_max = max_label_len(cfg)
    u8 = (str(cfg.TRANSFER_DTYPE) == 'uint8'
          and all(im.dtype == np.uint8 for im in resized))
    image = np.zeros((n, w_bucket, int(cfg.NUM_FEATURES)),
                     np.uint8 if u8 else np.float32)
    label = np.zeros((n, l_max), np.int32)
    label_len = np.zeros((n,), np.int32)
    time_step = np.zeros((n,), np.int32)
    for i, (im, lab) in enumerate(zip(resized, labels)):
        w = im.shape[1]
        if u8:
            image[i, :w, :] = im.swapaxes(0, 1).reshape(w, -1)
        else:
            image[i, :w, :] = (im.astype(np.float32) / 255.0) \
                .swapaxes(0, 1).reshape(w, -1)
        code = [encode_maps[c] for c in lab]
        assert len(code) <= l_max, f'label longer than MAX_LEN: {lab}'
        label[i, :len(code)] = code
        label_len[i] = len(code)
        time_step[i] = w // cfg.POOL_SCALE + cfg.OFFSET_TIME_STEP
    return DeviceBatch(image, label, label_len, time_step)
