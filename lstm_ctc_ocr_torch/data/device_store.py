"""Device-resident dataset: the pool and records backends held in device
memory, the port's counterpart of the JAX package's
``data/device_store.py``.

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

Two layouts, as in the JAX package. The replicated store
(:class:`DeviceStore`) holds the whole dataset; under a mesh
(``parallel/mesh.py``) every rank holds it, draws the same global indices
from one stream and gathers its rows of them (the JAX single-process
mesh). The sharded store (:class:`ShardedDeviceStore`,
:func:`make_sharded_device_feed`) is the layout of a multi-process run:
each rank holds only its own ``R``-row partition, built from its own seeds,
and gathers its ``B / D`` rows of every global batch by local row id; a
pool refresh is written into the rank's own partition, in place (the
JAX package's ``_update_blocks_fn`` scatter is each rank's
``flush_refresh``). This is the one module of the data package that
imports torch: the synthetic stream's worker processes never import it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import get_encode_decode_dict
from ..parallel.mesh import batch_sharded, chunk_sharded
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
    ``w_bucket``: the width every row is padded to (default: the widest
    row's bucket).
    """

    def __init__(self, images: List[np.ndarray], labels: List[str],
                 mode: str, np_rng: np.random.RandomState, cfg, device,
                 flush_every: int = 32, verbose: bool = True,
                 w_bucket: Optional[int] = None):
        if mode not in ('uniform', 'epoch'):
            raise ValueError('mode: uniform or epoch, got {!r}'.format(mode))
        self.cfg = cfg
        self.mode = mode
        self.device = torch.device(device)
        self._np_rng = np_rng
        self.n = len(images)
        self.w_bucket = w_bucket or pick_bucket(
            max(im.shape[1] for im in images), cfg.BUCKETS)
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
    dispatch group) int32 row indices on the store's device. Under a mesh,
    this rank's rows of the global indices: ``[N/D]``, ``[K, N/D]``."""

    layout = 'replicated'
    mesh = None

    def step_indices(self, batch_size: int) -> torch.Tensor:
        idx = self.next_indices(batch_size, 1)[0]
        if self.mesh is not None:
            idx = idx[batch_sharded(self.mesh, batch_size)]
        return to_device(idx, self.store.device)

    def chunk_indices(self, batch_size: int, k: int) -> torch.Tensor:
        idxs = self.next_indices(batch_size, k)
        if self.mesh is not None:
            idxs = idxs[chunk_sharded(self.mesh, batch_size)]
        return to_device(idxs, self.store.device)


class PoolDeviceFeed(_ReplicatedIndices):
    """Pool backend, device-resident: takes a ``PoolSampler``'s image set
    and RNG streams; ``tick`` renders ``POOL_REFRESH`` fresh rows per
    training step (``PoolSampler.batch_iterator``'s cadence) into the staged
    buffer."""

    def __init__(self, pool, device, verbose: bool = True, mesh=None):
        self.mesh = mesh
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

    def __init__(self, ds, seed: int, device, verbose: bool = True,
                 mesh=None):
        self.mesh = mesh
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


def make_device_feed(cfg, device, verbose: bool = True, mesh=None):
    """The ``DATA_DEVICE`` gate: a :class:`PoolDeviceFeed` or
    :class:`RecordsDeviceFeed` on ``device`` when the backend has a fixed
    dataset and the store fits, else None (host batches). With a ``mesh``,
    the whole store on every rank and one index stream, each rank taking
    its rows of it (the multi-process solver takes
    :func:`make_sharded_device_feed` instead).

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
        feed = RecordsDeviceFeed(ds, seed, device, verbose=verbose,
                                 mesh=mesh)
        ds.close()
        return feed
    from .pool import PoolSampler
    pool = PoolSampler(cfg, int(cfg.POOL_SIZE), seed=seed, verbose=verbose)
    return PoolDeviceFeed(pool, device, verbose=verbose, mesh=mesh)


class ShardedDeviceStore(DeviceStore):
    """This rank's partition of a dataset held across the ranks: the JAX
    package's ``ShardedDeviceStore``, a block a rank.

    ``images``/``labels`` are this rank's ``R`` rows; every rank pads to one
    bucket, the widest of the ranks' (one all-reduce). The sampler is this
    rank's own, seeded ``seed + 7919 * rank`` (the JAX seeds by global
    device id), and ``next_indices(global_batch, k)`` gives ``[k, B/D]``
    local row ids into this block; the block must hold a batch shard
    (``R >= B/D``), else ``ValueError``.

    Sampling is the distributed-loader contract, not the one stream of the
    replicated store. 'uniform': each rank draws its shard from its block
    without replacement. 'epoch': each rank walks shuffled permutations of
    its block in shards of ``B/D``; a permutation's last ``R mod (B/D)``
    rows are skipped and the next epoch reshuffles. The blocks are
    disjoint, so within one epoch no dataset row is visited twice, and
    every row of every block is visited exactly once when ``B/D`` divides
    ``R`` (and, for records, the ``len mod D`` rows no block holds never).
    """

    layout = 'sharded'

    def __init__(self, images: List[np.ndarray], labels: List[str],
                 mode: str, seed: int, mesh, cfg, device,
                 flush_every: int = 32, verbose: bool = True):
        self.mesh = mesh
        self.n_dev = int(mesh.size)
        w = mesh.all_max(pick_bucket(max(im.shape[1] for im in images),
                                     cfg.BUCKETS))
        super().__init__(images, labels, mode,
                         np.random.RandomState(int(seed) + 7919 * mesh.rank),
                         cfg, device, flush_every=flush_every, verbose=False,
                         w_bucket=w)
        self.rows = self.n
        if verbose:
            print('sharded device store: {} rows on rank {} @ bucket {} -> '
                  '{:.1f} MB on {} ({} ranks, {} rows globally)'.format(
                      self.rows, mesh.rank, w, self.nbytes / 1e6,
                      self.device, self.n_dev, self.rows * self.n_dev),
                  flush=True)

    def shard_size(self, global_batch: int) -> int:
        """``B/D``, checked to divide and to fit this rank's block."""
        if global_batch % self.n_dev:
            raise ValueError('a global batch of {} does not divide over {} '
                             'ranks'.format(global_batch, self.n_dev))
        b_dev = global_batch // self.n_dev
        if b_dev > self.rows:
            raise ValueError(
                'a batch shard of {} rows does not fit the {}-row partition '
                'of rank {}: grow the dataset or shrink the batch'.format(
                    b_dev, self.rows, self.mesh.rank))
        return b_dev

    def next_indices(self, global_batch: int, k: int = 1) -> np.ndarray:
        """``[k, B/D]`` int32 local row ids: this rank's ``k`` shards."""
        return super().next_indices(self.shard_size(global_batch), k)

    def stage_refresh(self, row: int, image: np.ndarray, label: str) -> None:
        """Queue a fresh row for this rank's block; it must fit the bucket
        (the pool feed re-renders a row that does not)."""
        if image.shape[1] > self.w_bucket:
            raise ValueError(
                'refresh row wider than the store bucket ({} > {}): callers '
                'must re-render (PoolShardedFeed.tick)'.format(
                    image.shape[1], self.w_bucket))
        super().stage_refresh(row, image, label)


class _ShardedIndices:
    """The solver-facing index API of the sharded feeds: ``[B/D]`` or
    ``[K, B/D]`` local row ids on the store's device."""

    layout = 'sharded'

    def step_indices(self, global_batch: int) -> torch.Tensor:
        return to_device(self.store.next_indices(global_batch, 1)[0],
                         self.store.device)

    def chunk_indices(self, global_batch: int, k: int) -> torch.Tensor:
        return to_device(self.store.next_indices(global_batch, k),
                         self.store.device)


class PoolShardedFeed(_ShardedIndices):
    """Pool backend over the sharded store: this rank renders its
    ``POOL_SIZE // D`` rows from its own seeds (``RNG_SEED + 104729 *
    rank`` for the images, ``+ 15485863 * rank`` for the refreshed rows, as
    the JAX feed seeds each device); ``tick`` refreshes ``POOL_REFRESH``
    rows a step."""

    def __init__(self, cfg, mesh, device, verbose: bool = True):
        import random
        from .pool import _render_resized
        self.cfg = cfg
        rows = max(1, int(cfg.POOL_SIZE) // int(mesh.size))
        seed = int(cfg.RNG_SEED)
        self._render_rng = random.Random(seed + 104729 * mesh.rank)
        self._refresh_rng = np.random.RandomState(seed + 15485863 * mesh.rank)
        if verbose:
            print('rendering {} sharded pool images on rank {}...'.format(
                rows, mesh.rank), flush=True)
        images, labels = [], []
        for _ in range(rows):
            im, lab = _render_resized(cfg, self._render_rng)
            images.append(im)
            labels.append(lab)
        self.store = ShardedDeviceStore(images, labels, 'uniform', seed, mesh,
                                        cfg, device, verbose=verbose)

    def tick(self, steps: int = 1) -> None:
        from .pool import _render_resized
        cfg, store = self.cfg, self.store
        for _ in range(int(cfg.POOL_REFRESH) * steps):
            row = int(self._refresh_rng.randint(store.rows))
            # a row wider than the bucket is rendered again; the bucket is
            # the widest of thousands of draws from this distribution, so a
            # miss is rare. 64 misses in a row: a blank row (an empty label
            # is valid CTC data), loudly
            for _ in range(64):
                im, lab = _render_resized(cfg, self._render_rng)
                if im.shape[1] <= store.w_bucket:
                    break
            else:
                print('sharded pool refresh: 64 consecutive renders wider '
                      'than the store bucket {}; staging a blank row (the '
                      'render distribution no longer fits the store)'.format(
                          store.w_bucket), flush=True)
                im = np.zeros((int(cfg.IMG_HEIGHT), store.w_bucket),
                              np.uint8)
                lab = ''
            store.stage_refresh(row, im, lab)


class RecordsShardedFeed(_ShardedIndices):
    """Records backend over the sharded store: rank ``r`` of ``D`` holds
    rows ``r, r + D, r + 2D, ...`` (``len // D`` of them; the ``len mod D``
    remainder rows, which would leave the blocks unequal, no rank
    holds)."""

    def __init__(self, ds, mesh, device, verbose: bool = True):
        n_dev = int(mesh.size)
        rows = len(ds) // n_dev
        if rows == 0:
            raise ValueError('records dataset smaller than the ranks ({} '
                             'rows, {} ranks)'.format(len(ds), n_dev))
        dropped = len(ds) - rows * n_dev
        if dropped and verbose and mesh.rank == 0:
            print('sharded store: dropping {} remainder rows ({} % {} ranks)'
                  .format(dropped, len(ds), n_dev))
        images, labels = [], []
        for r in range(rows):
            lab, im = ds.get_at_model_height(mesh.rank + r * n_dev)
            images.append(im)
            labels.append(lab)
        self.store = ShardedDeviceStore(images, labels, 'epoch',
                                        int(ds.cfg.RNG_SEED), mesh, ds.cfg,
                                        device, verbose=verbose)

    def tick(self, steps: int = 1) -> None:   # records never refresh
        pass


def make_sharded_device_feed(cfg, batch_size: int, mesh, device,
                             verbose: bool = True):
    """The ``DATA_DEVICE`` gate of a multi-process run: this rank's
    :class:`PoolShardedFeed` or :class:`RecordsShardedFeed` when the backend
    has a fixed dataset, the global batch divides over the ranks, a batch
    shard fits a rank's partition and (for 'auto') a rank's share of the
    store fits ``DATA_DEVICE_MAX_MB``; else None (host batches), with the
    decline protocol of :func:`make_device_feed`."""
    setting, backend, decline = _feed_gate(cfg, verbose)
    if setting == 'off':
        return None
    if not _backend_or_decline(backend, decline):
        return None
    n_dev = int(mesh.size)
    if batch_size % n_dev:
        return decline('global batch {} does not divide over the {} ranks'
                       .format(batch_size, n_dev))
    if backend == 'records':
        from .records import RecordsDataset
        ds = RecordsDataset(str(cfg.RECORDS_PATH), cfg, cache_resized=False)
        rows = len(ds) // n_dev
        ds.close()
    else:
        rows = max(1, int(cfg.POOL_SIZE) // n_dev)
    if batch_size // n_dev > rows:
        return decline('a batch shard of {} rows does not fit a {}-row '
                       'partition ({} ranks)'.format(batch_size // n_dev,
                                                     rows, n_dev))
    if setting == 'auto':
        est_mb = estimate_store_mb(cfg, backend) / n_dev
        if est_mb > float(cfg.DATA_DEVICE_MAX_MB):
            return decline(
                'estimated store share of a rank {:.0f} MB exceeds '
                'DATA_DEVICE_MAX_MB={}'.format(est_mb, cfg.DATA_DEVICE_MAX_MB))
    if backend == 'records':
        from .records import RecordsDataset
        ds = RecordsDataset(str(cfg.RECORDS_PATH), cfg,
                            cache_resized=bool(cfg.RECORDS_CACHE_RESIZED))
        if verbose:
            print('records backend (sharded device store): {} examples from '
                  '{}'.format(len(ds), cfg.RECORDS_PATH))
        feed = RecordsShardedFeed(ds, mesh, device, verbose=verbose)
        ds.close()
        return feed
    return PoolShardedFeed(cfg, mesh, device, verbose=verbose)
