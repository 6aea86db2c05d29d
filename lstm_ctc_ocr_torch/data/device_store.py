"""Device-resident dataset: the pool and records backends held in device
memory, the port's counterpart of the JAX package's
``data/device_store.py`` (its replicated, one-device layout).

The whole dataset is uploaded once as raw uint8 rows padded to one width
bucket, and each step sends only its sampled row indices (``[N]`` or
``[K, N]`` int32); the train step gathers its batch on the device with
``index_select`` (``engine/train.py:make_train_step_gather`` and
``make_train_chunk(gather=True)``). With the per-step image copy gone, the
K-step CUDA graph of ``TRAIN.STEPS_PER_DISPATCH`` runs with nothing between
host and device but a ``[K, N]`` index array.

Semantics, as in the JAX package:

* The gathered pixels, labels, lengths and time steps are identical to
  what ``gen.bucket_batch`` builds for the same rows at the store's bucket,
  and the samplers consume the same RNG streams in the same order as the
  JAX store's (pool: ``PoolSampler``'s choice and refresh streams; records:
  the permutation walk of ``RecordsDataset.batch_iterator``).
* Every batch is padded to the one store-wide bucket (the widest row's).
  The host feed pads each batch to its own sampled bucket, so the two
  differ where a batch holds only narrow rows: training-mode batch norm
  takes its statistics over the padded columns too.
* Pool refresh renders on the host and stages the rows; a flush every
  ``flush_every`` staged rows writes them into the store tensors IN PLACE
  (``index_copy_``): a captured CUDA graph holds the store's pointers, so a
  flush that reallocated would leave the graph training on stale rows.

``DATA_DEVICE`` gates it (:func:`make_device_feed`): ``off`` never, ``on``
always (raising where it cannot), ``auto`` for pool and records when the
estimated store fits ``DATA_DEVICE_MAX_MB``, saying why when it declines.
The multi-device layout (the JAX package's ``ShardedDeviceStore`` and its
feeds) waits for data parallelism. This is the one module of the data
package that imports torch: the synthetic stream's worker processes never
import it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import get_encode_decode_dict
from .gen import max_label_len, pick_bucket


def _pack_rows(images: List[np.ndarray], labels: List[str], w_bucket: int,
               cfg) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack (image, label) rows into the store layout: exactly the pixel
    placement of ``gen.bucket_batch``'s uint8 path (width-major, zero
    right-pad, dense 0-padded labels, time_step = w // POOL_SCALE +
    OFFSET_TIME_STEP)."""
    encode_maps, _ = get_encode_decode_dict(cfg)
    n = len(images)
    l_max = max_label_len(cfg)
    feat = int(cfg.NUM_FEATURES)
    img = np.zeros((n, w_bucket, feat), np.uint8)
    lab = np.zeros((n, l_max), np.int32)
    lab_len = np.zeros((n,), np.int32)
    t_step = np.zeros((n,), np.int32)
    for i, (im, s) in enumerate(zip(images, labels)):
        w = im.shape[1]
        if w > w_bucket:
            raise ValueError('row {} is {} wide, past the store bucket {}'
                             .format(i, w, w_bucket))
        img[i, :w, :] = im.swapaxes(0, 1).reshape(w, -1)
        code = [encode_maps[c] for c in s]
        if len(code) > l_max:
            raise ValueError('label longer than MAX_LEN: {}'.format(s))
        lab[i, :len(code)] = code
        lab_len[i] = len(code)
        t_step[i] = w // int(cfg.POOL_SCALE) + int(cfg.OFFSET_TIME_STEP)
    return img, lab, lab_len, t_step


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without waiting for the device's
    queue: through pinned memory on CUDA (a copy from pageable memory
    waits for the stream to drain first)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DeviceStore:
    """Device-resident (image, label) rows and a host-side index sampler.

    ``mode='uniform'``: per batch ``choice(n, batch, replace=False)`` from
    ``np_rng`` (``PoolSampler.sample_batch``'s stream).
    ``mode='epoch'``: a shuffled permutation walk
    (``RecordsDataset.batch_iterator``'s; drops the remainder under a batch).
    """

    def __init__(self, images: List[np.ndarray], labels: List[str],
                 mode: str, np_rng: np.random.RandomState, cfg, device,
                 flush_every: int = 32, verbose: bool = True):
        if mode not in ('uniform', 'epoch'):
            raise ValueError('mode: uniform or epoch, got {!r}'.format(mode))
        self.cfg = cfg
        self.mode = mode
        self.device = torch.device(device)
        self._np_rng = np_rng
        self.n = len(images)
        self.w_bucket = pick_bucket(max(im.shape[1] for im in images),
                                    cfg.BUCKETS)
        img, lab, lab_len, t_step = _pack_rows(images, labels, self.w_bucket,
                                               cfg)
        self.nbytes = img.nbytes + lab.nbytes + lab_len.nbytes + t_step.nbytes
        if verbose:
            print('device store: {} rows @ bucket {} -> {:.1f} MB on {}'
                  .format(self.n, self.w_bucket, self.nbytes / 1e6,
                          self.device), flush=True)
        self.img, self.lab, self.lab_len, self.t_step = (
            to_device(a, self.device) for a in (img, lab, lab_len, t_step))
        self._order: Optional[np.ndarray] = None     # epoch mode
        self._pos = 0
        # refresh buffer: (row, image, label) triples awaiting a flush
        self._flush_every = int(flush_every)
        self._pending: List[Tuple[int, np.ndarray, str]] = []

    @property
    def arrays(self):
        return self.img, self.lab, self.lab_len, self.t_step

    # ---- sampling ------------------------------------------------------
    def next_indices(self, batch_size: int, k: int = 1) -> np.ndarray:
        """[k, batch_size] int32 row indices: k consecutive batches (one
        dispatch group). Consumes the RNG exactly like the host samplers."""
        out = np.empty((k, batch_size), np.int32)
        for j in range(k):
            if self.mode == 'uniform':
                out[j] = self._np_rng.choice(self.n, size=batch_size,
                                             replace=False)
            else:
                if self._order is None or self._pos + batch_size > self.n:
                    self._order = self._np_rng.permutation(self.n)
                    self._pos = 0
                out[j] = self._order[self._pos:self._pos + batch_size]
                self._pos += batch_size
        return out

    # ---- pool-style refresh ---------------------------------------------
    def stage_refresh(self, row: int, image: np.ndarray, label: str) -> None:
        """Queue a freshly rendered replacement of ``row``; staged rows are
        flushed in blocks of ``flush_every``. A row wider than the store
        bucket cannot fit and is skipped, with a line saying so."""
        if image.shape[1] > self.w_bucket:
            print('device store: skipping refresh row wider than bucket '
                  '({} > {})'.format(image.shape[1], self.w_bucket))
            return
        self._pending.append((row, image, label))
        if len(self._pending) >= self._flush_every:
            self.flush_refresh()

    def flush_refresh(self) -> None:
        """Write the staged rows into the store tensors in place, on the
        current stream (after every step queued before it). A row staged
        twice keeps its later image, as the host pool's sequential
        overwrite does."""
        if not self._pending:
            return
        last = {}
        for r, im, s in self._pending:
            last[r] = (im, s)
        self._pending = []
        rows = np.asarray(list(last), np.int64)
        packed = _pack_rows([im for im, _ in last.values()],
                            [s for _, s in last.values()], self.w_bucket,
                            self.cfg)
        rows_d = to_device(rows, self.device)
        for dst, src in zip(self.arrays, packed):
            dst.index_copy_(0, rows_d, to_device(src, self.device))


class _ReplicatedIndices:
    """The solver-facing index API: ``[N]`` (one step) or ``[K, N]`` (one
    dispatch group) int32 row indices on the store's device."""

    layout = 'replicated'

    def step_indices(self, batch_size: int) -> torch.Tensor:
        return to_device(self.next_indices(batch_size, 1)[0],
                         self.store.device)

    def chunk_indices(self, batch_size: int, k: int) -> torch.Tensor:
        return to_device(self.next_indices(batch_size, k), self.store.device)


class PoolDeviceFeed(_ReplicatedIndices):
    """Pool backend, device-resident: takes a ``PoolSampler``'s image set
    and RNG streams; ``tick`` renders ``POOL_REFRESH`` fresh rows per
    training step (``PoolSampler.batch_iterator``'s cadence) into the staged
    buffer."""

    def __init__(self, pool, device, verbose: bool = True):
        self._pool = pool
        self.store = DeviceStore(pool.images, pool.labels, 'uniform',
                                 pool._np_rng, pool.cfg, device,
                                 verbose=verbose)
        # the host copy was only needed to build the store (the disk cache,
        # not this list, serves restarts)
        pool.images, pool.labels = [], []

    def next_indices(self, batch_size: int, k: int = 1) -> np.ndarray:
        return self.store.next_indices(batch_size, k)

    def tick(self, steps: int = 1) -> None:
        from .pool import _render_resized
        cfg = self._pool.cfg
        for _ in range(int(cfg.POOL_REFRESH) * steps):
            row = int(self._pool._np_rng.randint(self.store.n))
            im, lab = _render_resized(cfg, self._pool._rng)
            self.store.stage_refresh(row, im, lab)


class RecordsDeviceFeed(_ReplicatedIndices):
    """Records backend, device-resident: reads every record at model height
    once (the resize path batches use), uploads, then walks shuffled epochs
    exactly like ``RecordsDataset.batch_iterator``."""

    def __init__(self, ds, seed: int, device, verbose: bool = True):
        images, labels = [], []
        for i in range(len(ds)):
            lab, im = ds.get_at_model_height(i)
            images.append(im)
            labels.append(lab)
        self.store = DeviceStore(images, labels, 'epoch',
                                 np.random.RandomState(seed), ds.cfg, device,
                                 verbose=verbose)

    def next_indices(self, batch_size: int, k: int = 1) -> np.ndarray:
        return self.store.next_indices(batch_size, k)

    def tick(self, steps: int = 1) -> None:   # records never refresh
        pass


def _feed_gate(cfg, verbose: bool):
    """The ``DATA_DEVICE`` setting, the backend, and the decline protocol:
    'on' raises with the reason, 'auto' prints it (a silent fall-back to
    host batches would show only as a slower run)."""
    setting = str(cfg.DATA_DEVICE)
    backend = str(cfg.DATA_BACKEND)

    def decline(why):
        if setting == 'on':
            raise ValueError("DATA_DEVICE 'on': " + why)
        if verbose:
            print('DATA_DEVICE auto: using host batches — ' + why,
                  flush=True)
        return None

    return setting, backend, decline


def _backend_or_decline(backend, decline):
    """True when the backend has a fixed dataset to upload; else the loud
    decline, in the JAX package's words."""
    if backend in ('pool', 'records'):
        return True
    decline("backend '{}' has no fixed dataset to upload (pool|records "
            'only; synth is an unbounded stream)'.format(backend))
    return False


def estimate_store_mb(cfg, backend: str) -> float:
    """Cheap size estimate of the store before it is built, for 'auto'."""
    l_max = max_label_len(cfg)
    feat = int(cfg.NUM_FEATURES)
    if backend == 'records':
        from .records import RecordsDataset
        ds = RecordsDataset(str(cfg.RECORDS_PATH), cfg, cache_resized=False)
        n = len(ds)
        # a few rows give the width scale (the resize keeps the aspect)
        ws = []
        for i in range(0, n, max(1, n // 64)):
            _, im = ds.get(i)
            ws.append(im.shape[1] * int(cfg.IMG_HEIGHT) / im.shape[0])
        ds.close()
        w_bucket = pick_bucket(int(max(ws)) + 4, cfg.BUCKETS)
    else:
        n = int(cfg.POOL_SIZE)
        w_bucket = int(cfg.BUCKETS[-1])           # conservative
    return n * (w_bucket * feat + 4 * l_max + 8) / 1e6


def make_device_feed(cfg, device, verbose: bool = True):
    """The ``DATA_DEVICE`` gate: a :class:`PoolDeviceFeed` or
    :class:`RecordsDeviceFeed` on ``device`` when the backend has a fixed
    dataset and the store fits, else None (host batches).

    'auto' requires a pool or records backend and an estimated store under
    ``DATA_DEVICE_MAX_MB``; a declined 'auto' says which gate declined, and
    'on' raises ``ValueError`` with the same reason."""
    setting, backend, decline = _feed_gate(cfg, verbose)
    if setting == 'off':
        return None
    if not _backend_or_decline(backend, decline):
        return None
    if setting == 'auto':
        est_mb = estimate_store_mb(cfg, backend)
        if est_mb > float(cfg.DATA_DEVICE_MAX_MB):
            return decline(
                'estimated store {:.0f} MB exceeds DATA_DEVICE_MAX_MB={} '
                '(raise the cap or set DATA_DEVICE on to force)'.format(
                    est_mb, cfg.DATA_DEVICE_MAX_MB))
    seed = int(cfg.RNG_SEED)
    if backend == 'records':
        from .records import RecordsDataset
        ds = RecordsDataset(str(cfg.RECORDS_PATH), cfg,
                            cache_resized=bool(cfg.RECORDS_CACHE_RESIZED))
        if verbose:
            print('records backend (device-resident): {} examples from {}'
                  .format(len(ds), cfg.RECORDS_PATH))
        feed = RecordsDeviceFeed(ds, seed, device, verbose=verbose)
        ds.close()
        return feed
    from .pool import PoolSampler
    pool = PoolSampler(cfg, int(cfg.POOL_SIZE), seed=seed, verbose=verbose)
    return PoolDeviceFeed(pool, device, verbose=verbose)
