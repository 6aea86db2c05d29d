"""Pooled synthetic sampler, the port's copy of the JAX package's
``data/pool.py``: amortise captcha rendering on weak hosts.

The sampler renders ``POOL_SIZE`` images once, then serves batches by
sampling the pool, re-rendering ``POOL_REFRESH`` images per batch so that
the pool drifts toward fresh data. Selected with ``DATA_BACKEND: pool``.

The initial fill is cached under ``data/pool_cache/`` (relative to the
working directory) in a file named by the sha1 of the same key string as
the JAX package's, in the same ``.npz`` layout, so a cache written by
either package loads in the other. The RNG streams (``random.Random`` for
labels and renders, ``np.random.RandomState`` for sampling, a sha1-derived
reseed after a cache load) are consumed in the JAX package's order.
"""

from __future__ import annotations

import hashlib
import os
import random
import zipfile
from typing import Iterator, List, Optional

import numpy as np

from ..config import resolve_font
from .gen import DeviceBatch, bucket_batch, generate_img, resize_keep_aspect


def _render_resized(cfg, rng):
    """Render one example already resized to IMG_HEIGHT, so that sampling a
    pool image costs no resize per batch (the same pixels bucket_batch
    would produce)."""
    im, lab = generate_img(cfg, rng)
    if im.shape[0] != int(cfg.IMG_HEIGHT):   # native renderer: already there
        im = resize_keep_aspect(im, cfg.IMG_HEIGHT)
    return im, lab


def cache_path(cfg, size: int, seed: int) -> str:
    """The cache file of the initial fill. The key covers everything the
    rendered distribution depends on, the font file actually used included;
    a config change misses the cache and renders anew."""
    try:
        font_used = resolve_font(cfg)
    except FileNotFoundError:
        font_used = cfg.FONT
    key = '|'.join(str(v) for v in (
        cfg.RENDERER, font_used, cfg.CHARSET, cfg.MIN_LEN, cfg.MAX_LEN,
        cfg.IMG_HEIGHT, size, seed))
    h = hashlib.sha1(key.encode()).hexdigest()[:12]
    return os.path.join('data', 'pool_cache', 'pool_{}.npz'.format(h))


def _cache_load(path: str):
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as d:
            strip = np.ascontiguousarray(d['strip'])
            widths, labels = d['widths'], d['labels']
    except (OSError, EOFError, ValueError, KeyError,
            zipfile.BadZipFile) as e:            # corrupt/partial cache
        print('pool cache unreadable ({}); re-rendering'.format(e))
        return None
    images, off = [], 0
    for w in widths:
        images.append(strip[:, off:off + int(w)].copy())
        off += int(w)
    return images, [str(s) for s in labels]


def _cache_save(path: str, images, labels) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    strip = np.concatenate(images, axis=1)       # equal heights (IMG_HEIGHT)
    widths = np.asarray([im.shape[1] for im in images], np.int32)
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    with open(tmp, 'wb') as f:
        np.savez(f, strip=strip, widths=widths,
                 labels=np.asarray(labels, dtype=str))
    os.replace(tmp, path)                        # atomic vs concurrent fills


class PoolSampler:
    def __init__(self, cfg, size: int, seed: int = 0, verbose: bool = True):
        self.cfg = cfg
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        self.images: List[np.ndarray] = []
        self.labels: List[str] = []
        # the fill is deterministic in (cfg, size, seed): a restart loads it
        path = cache_path(cfg, size, seed)
        loaded = _cache_load(path)
        if loaded is not None:
            self.images, self.labels = loaded
            # the fill that would have consumed the rng streams was skipped:
            # reseed both so refresh() renders fresh images instead of
            # replaying the pool's contents
            digest = hashlib.sha1(
                'cache-resume|{}'.format(seed).encode()).digest()
            resume_seed = int.from_bytes(digest[:4], 'little') & 0x7FFFFFFF
            self._rng = random.Random(resume_seed)
            self._np_rng = np.random.RandomState(resume_seed ^ 0x5DEECE66)
            if verbose:
                print('pool: loaded {} cached images ({})'.format(
                    len(self.images), path), flush=True)
            return
        if verbose:
            print('rendering {} pool images...'.format(size), flush=True)
        for i in range(size):
            im, lab = _render_resized(cfg, self._rng)
            self.images.append(im)
            self.labels.append(lab)
            if verbose and (i + 1) % 5000 == 0:
                print('  pool: {}/{}'.format(i + 1, size), flush=True)
        _cache_save(path, self.images, self.labels)

    def refresh(self, k: int) -> None:
        for _ in range(k):
            j = self._np_rng.randint(len(self.images))
            im, lab = _render_resized(self.cfg, self._rng)
            self.images[j] = im
            self.labels[j] = lab

    def sample_batch(self, batch_size: int) -> DeviceBatch:
        idx = self._np_rng.choice(len(self.images), size=batch_size,
                                  replace=False)
        return bucket_batch([self.images[i] for i in idx],
                            [self.labels[i] for i in idx], self.cfg)

    def batch_iterator(self, batch_size: int,
                       refresh_per_batch: Optional[int] = None
                       ) -> Iterator[DeviceBatch]:
        if refresh_per_batch is None:
            refresh_per_batch = int(self.cfg.POOL_REFRESH)
        while True:
            yield self.sample_batch(batch_size)
            if refresh_per_batch:
                self.refresh(refresh_per_batch)
