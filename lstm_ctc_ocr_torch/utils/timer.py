"""Lap timer for per-image timing (the port's copy of the JAX package's
``utils/timer.py``, on the monotonic ``time.perf_counter`` clock)."""

import time
from collections import deque


class Timer:
    """Accumulates laps between ``tic()`` and ``toc()``.

    ``toc(average=True)`` returns the mean lap so far; ``toc(average=False)``
    returns the lap just closed. ``keep=N`` restricts the reported mean to a
    sliding window of the last N laps (0 = all laps, tracked as a running
    sum without storing each one).
    """

    def __init__(self, keep: int = 0):
        self._window = deque(maxlen=keep) if keep else None
        self._sum = 0.0
        self._count = 0
        self._t0 = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        if self._t0 is None:
            raise RuntimeError('toc() before tic()')
        lap = time.perf_counter() - self._t0
        self._sum += lap
        self._count += 1
        if self._window is not None:
            self._window.append(lap)
        return self.average_time if average else lap

    @property
    def average_time(self) -> float:
        if self._window:
            return sum(self._window) / len(self._window)
        return self._sum / self._count if self._count else 0.0

    @property
    def total_time(self) -> float:
        return self._sum

    @property
    def calls(self) -> int:
        return self._count
