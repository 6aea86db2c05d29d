"""Multiprocess generator prefetcher, the port's copy of the JAX package's
``data/enqueuer.py``.

N daemon worker processes each run a copy of a Python generator and push
results into a shared bounded queue; the consumer drains the queue. A
shared stop event gives clean shutdown, and a worker exception sets the
stop event so the consumer raises instead of hanging.

* ``workers=0`` runs the generator inline: deterministic single-process
  mode for tests and for hosts with one core.
* Worker ``i`` gets the seed ``seed * 1_000_003 + i``, so the streams are
  decorrelated rather than fork-identical.
* Workers render with numpy and ctypes only. Under ``fork`` in a process
  that holds a CUDA context they must not touch CUDA, as with a
  ``DataLoader``: nothing the data path imports does.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import random
import time
from typing import Callable, Iterator


def _call_factory(factory, seed):
    """Factories may take an optional seed argument (get_batch's does, so
    inline mode is deterministic per stream); zero-arg factories rely on
    the process-global seeding below."""
    try:
        import inspect
        if len(inspect.signature(factory).parameters) >= 1:
            return factory(seed)
    except (TypeError, ValueError):
        pass
    return factory()


def _worker_loop(gen_factory, q, stop_event, seed):
    # Never block process exit on flushing buffered items into a pipe the
    # consumer may have stopped reading (shutdown deadlock otherwise).
    q.cancel_join_thread()
    random.seed(seed)
    try:
        import numpy as np
        np.random.seed(seed % (2 ** 31))
    except Exception:
        pass
    try:
        gen = _call_factory(gen_factory, seed)
        while not stop_event.is_set():
            item = next(gen)
            while not stop_event.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except _queue.Full:
                    continue
    except Exception:
        stop_event.set()
        raise


class GeneratorEnqueuer:
    """Prefetch items from ``gen_factory()`` generators in worker processes."""

    def __init__(self, gen_factory: Callable[[], Iterator], seed: int = 0):
        self._gen_factory = gen_factory
        self._seed = seed
        self._workers = []
        self._stop_event = None
        self.queue = None
        self._inline_gen = None

    def start(self, workers: int = 4, max_queue_size: int = 24,
              start_method: str = 'fork') -> None:
        """``start_method``: 'fork' (fast; the reference's behavior) or
        'spawn' (safe in multi-threaded parents, and the future CPython
        default; requires a picklable factory)."""
        if workers <= 0:
            # inline mode honors the seed too (the docstring's determinism
            # contract); seed-aware factories get it passed explicitly
            self._inline_gen = _call_factory(self._gen_factory, self._seed)
            return
        ctx = mp.get_context(start_method)
        self.queue = ctx.Queue(maxsize=max_queue_size)
        self._stop_event = ctx.Event()
        for i in range(workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(self._gen_factory, self.queue, self._stop_event,
                      self._seed * 1_000_003 + i),
                daemon=True)
            p.start()
            self._workers.append(p)

    def is_running(self) -> bool:
        if self._inline_gen is not None:
            return True
        return self._stop_event is not None and not self._stop_event.is_set()

    def get(self, timeout: float = 60.0):
        """Blocking fetch of the next prefetched item."""
        if self._inline_gen is not None:
            return next(self._inline_gen)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not self.is_running():
                raise RuntimeError('GeneratorEnqueuer workers stopped unexpectedly')
            try:
                return self.queue.get(timeout=0.1)
            except _queue.Empty:
                continue
        raise TimeoutError('GeneratorEnqueuer.get timed out after {}s'.format(timeout))

    def stop(self, timeout: float = 5.0) -> None:
        if self._inline_gen is not None:
            self._inline_gen = None
            return
        if self._stop_event is not None:
            self._stop_event.set()
        for p in self._workers:
            p.join(timeout=timeout)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        # Do NOT drain: a terminated worker can leave a partial pickle in the
        # pipe, and a "non-blocking" get would then block in _recv_bytes()
        # waiting for bytes that never arrive. cancel_join_thread() is enough
        # to keep queue state from blocking interpreter exit.
        if self.queue is not None:
            self.queue.cancel_join_thread()
            self.queue.close()
        self._workers = []
