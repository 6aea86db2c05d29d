"""The synthetic captcha stream and fixed-shape batches: the port's
counterpart of the JAX package's ``data/gen.py``.

* ``gen_rand`` draws a label of MIN_LEN..MAX_LEN characters of ``CHARSET``;
  ``generate_img`` renders it with the renderer of ``RENDERER`` (``captcha``
  and ``scene`` with Pillow, ``native`` with the C++ renderer and no
  Pillow); ``generator`` groups rendered images into batches and
  ``get_batch`` runs it inline or in worker processes
  (``data/enqueuer.py``). The same seed gives the same labels, images and
  batches as the JAX package's functions.
* ``bucket_batch`` resizes every image to the model height (aspect kept,
  ``data/image.py:resize_linear``, bit-exact to ``cv2.resize``), right-pads
  the width to one bucket, lays the pixels out width-major and encodes the
  labels densely, so that every batch of a bucket has one static shape;
  ``group_batch`` is the reference's unbucketed 4-tuple.

``cfg`` is passed to each function. Nothing here imports torch, so worker
processes forked from a process that holds a CUDA context never touch it.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..config import get_encode_decode_dict, resolve_font
from .enqueuer import GeneratorEnqueuer
from .image import resize_linear


def gen_rand(cfg, rng=None) -> str:
    """Random label: MIN_LEN..MAX_LEN characters drawn from CHARSET."""
    rng = rng or random
    n = rng.randint(cfg.MIN_LEN, cfg.MAX_LEN)
    return ''.join(rng.choice(cfg.CHARSET) for _ in range(n))


_renderer_cache = {}


def _renderer(cfg):
    """The renderer of ``cfg.RENDERER``: 'captcha' (PIL, the default),
    'scene' (PIL, photo-like text lines) or 'native' (``native/synth.cpp``,
    no PIL). Cached per (renderer, font, charset, height): renderers load
    the font or the glyph atlas when they are made."""
    font = resolve_font(cfg)
    key = (str(cfg.RENDERER), font, str(cfg.CHARSET), int(cfg.IMG_HEIGHT))
    r = _renderer_cache.get(key)
    if r is None:
        if key[0] == 'scene':
            from .scene import SceneTextRenderer
            r = SceneTextRenderer(fonts=[font])
        elif key[0] == 'native':
            from ..native.synth import NativeCaptcha
            r = NativeCaptcha(key[2], font, key[3])
        else:
            from .captcha import ImageCaptcha
            r = ImageCaptcha(fonts=[font])
        _renderer_cache[key] = r
    return r


def generate_img(cfg, rng=None):
    """Render one text line -> (grayscale uint8 [H, W] array, label)."""
    chars = gen_rand(cfg, rng)
    img = _renderer(cfg).generate_image(chars, rng=rng)
    if isinstance(img, np.ndarray):       # native renderer: already gray,
        return img, chars                 # already at model height
    if cfg.NCHANNELS == 1:
        img = img.convert('L')
    return np.asarray(img), chars


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


def group_batch(imgs: List[np.ndarray], labels: List[str], cfg):
    """The reference's unbucketed batch: ``(img_batch, label_vec,
    label_len, time_steps)``, ``img_batch`` a list of ``[W_pad, 32]``
    float32 width-major arrays padded to the batch's widest image rounded up
    to POOL_SCALE, ``label_vec`` the batch's labels flattened."""
    encode_maps, _ = get_encode_decode_dict(cfg)
    nh = int(cfg.IMG_HEIGHT)
    max_w = 0
    time_steps, label_len, label_vec = [], [], []
    resized = []
    for img, label in zip(imgs, labels):
        img = resize_keep_aspect(img, nh)
        nw = img.shape[1]
        max_w = max(max_w, nw)
        resized.append(img)
        time_steps.append(nw // cfg.POOL_SCALE + cfg.OFFSET_TIME_STEP)
        label_vec.extend(encode_maps[c] for c in label)
        label_len.append(len(label))
    max_w = math.ceil(max_w / cfg.POOL_SCALE) * cfg.POOL_SCALE
    img_batch = []
    for img in resized:
        img = np.pad(img, ((0, 0), (0, max_w - img.shape[1]))
                     ).astype(np.float32) / 255.0
        img = img.swapaxes(0, 1)                      # [W_pad, 32] width-major
        img_batch.append(np.reshape(img, [-1, cfg.NUM_FEATURES]))
    return img_batch, label_vec, label_len, time_steps


def generator(cfg, batch_size: int = 32, bucketed: bool = True, rng=None):
    """Yield batches of freshly rendered captchas: :class:`DeviceBatch`
    (``bucketed=True``) or :func:`group_batch`'s 4-tuple."""
    images: List[np.ndarray] = []
    labels: List[str] = []
    failures = 0
    while True:
        try:
            im, label = generate_img(cfg, rng)
            images.append(im)
            labels.append(label)
            if len(images) == batch_size:
                if bucketed:
                    yield bucket_batch(images, labels, cfg)
                else:
                    yield group_batch(images, labels, cfg)
                images, labels = [], []
            failures = 0
        except Exception as e:
            # a transient error drops the partial batch and goes on, as the
            # JAX generator does; a persistent one (a bad charset, a missing
            # font or Pillow) fails on its tenth repeat instead of spinning
            failures += 1
            print('generator error ({}/10):'.format(failures), e)
            import traceback
            traceback.print_exc()
            images, labels = [], []
            if failures >= 10:
                raise
            continue


class _GeneratorFactory:
    """Picklable seed-aware generator factory: a module-level class, not a
    closure, so that worker processes receive it under 'spawn' as well as
    'fork'."""

    def __init__(self, cfg, kwargs, explicit_rng=None):
        self.cfg = cfg
        self.kwargs = kwargs
        self.explicit_rng = explicit_rng   # test hook; inline mode only

    def __call__(self, s=None):
        rng = self.explicit_rng if self.explicit_rng is not None \
            else (random.Random(s) if s is not None else None)
        return generator(self.cfg, rng=rng, **self.kwargs)


def get_batch(cfg, num_workers: int, seed: int = 0, **kwargs):
    """Prefetching batch stream. ``num_workers=0`` runs inline
    (deterministic); worker processes start by ``cfg.MP_START``. Returns a
    generator; closing it stops the workers."""
    explicit_rng = kwargs.pop('rng', None)
    enq = GeneratorEnqueuer(_GeneratorFactory(cfg, kwargs, explicit_rng),
                            seed=seed)
    enq.start(workers=num_workers, start_method=str(cfg.MP_START))

    def _stream():
        try:
            while True:
                yield enq.get()
        finally:
            enq.stop()
    return _stream()
