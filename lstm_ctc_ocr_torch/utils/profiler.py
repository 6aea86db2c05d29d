"""Profiling: a ``torch.profiler`` trace around a window of train steps.

Counterpart of the JAX package's ``utils/profiler.py``, with the same
window, API and printed lines. Set ``PROFILE_DIR`` (``--set PROFILE_DIR
'"logs/profile"'``) and the solver traces the steps ``[PROFILE_START,
PROFILE_START + PROFILE_STEPS)`` with ``torch.profiler``: host activity, and
on a CUDA device the card's kernels and copies too (the hand kernels by
name, e.g. ``bilstm_fwd_cluster_kernel``, ``ctc_fwd_warp_kernel``). The
trace is a Chrome/TensorBoard file, ``<host>_<pid>.<ns>.pt.trace.json``
under ``PROFILE_DIR`` (``torch.profiler.tensorboard_trace_handler``), so
under data parallelism every rank traces, as every JAX host does, into a
file of its own.

The window follows the JAX semantics exactly. ``step(it)`` is called once
per dispatch with the dispatch's first iteration; with
``TRAIN.STEPS_PER_DISPATCH`` = K > 1, ``it`` advances K a dispatch, the
trace starts at the first dispatch whose ``it`` lies in the window and
stops at the first whose ``it`` lies past it, and a dispatch that jumps over
the whole window traces nothing. With K-step CUDA graphs a replay shows in
the trace as the kernels of its K steps, each by name, as eager steps do.

Usage in a loop::

    prof = StepProfiler(cfg=cfg, device=dev)  # no-op unless PROFILE_DIR
    for it in ...:
        prof.step(it)              # starts/stops the trace at the window
    prof.close()                   # safety stop on early exit

Tracing changes no number the steps compute.

Spans and counters of the program's layers: ``span(name)`` is a
``torch.profiler.record_function`` range and ``count(name, n)`` adds to an
in-memory counter, both only while a ``torch.profiler`` trace is recording
(``StepProfiler``'s, or any other caller's) in the calling thread (the
profiler's state is a thread's own), so a span lands in the same trace as
the card's kernels, on its clock. With no trace they do nothing:
one check of the profiler's state, then a shared ``nullcontext``. They do
nothing either while torch exports or compiles, or while a CUDA graph is
captured, so exported programs and captured graphs hold no trace of them.
``counters()`` is a copy of the counts taken so far::

    with span('serve.prepare'):
        ...
    count('serve.images', len(imgs))

A name starts with its layer's prefix: ``serve.``, ``eval.``, ``beam.``,
``solver.``.
"""

from __future__ import annotations

import contextlib
import os

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts = {}


def _eager() -> bool:
    """Not an export, a compile or a CUDA graph's capture (asked only
    while a trace records: the off path is the profiler's check alone)."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return False
    return not (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())


def span(name: str):
    """A context manager: the profiler's range ``name`` while a trace is
    recording, else nothing."""
    if not _profiler_enabled() or not _eager():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a trace is recording."""
    if _profiler_enabled() and _eager():
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the counts taken while traces recorded."""
    return dict(_counts)


class StepProfiler:
    """Captures a ``torch.profiler`` trace for a window of steps.

    ``trace_dir``, ``start`` and ``num_steps`` default to ``cfg``'s
    ``PROFILE_DIR``, ``PROFILE_START`` and ``PROFILE_STEPS``; without a
    ``cfg`` or a ``trace_dir`` the profiler is disabled. ``device`` is the
    model's device: CUDA activity is recorded where it is a CUDA device.
    It defaults to this process's CUDA device and raises without one, as
    the entry points do; the CPU comes only from ``device='cpu'``."""

    def __init__(self, trace_dir=None, start=None, num_steps=None, cfg=None,
                 device=None):
        def pick(value, key, default):
            if value is not None:
                return value
            return cfg[key] if cfg is not None else default
        self.trace_dir = str(pick(trace_dir, 'PROFILE_DIR', ''))
        self.start = int(pick(start, 'PROFILE_START', 0))
        self.num_steps = int(pick(num_steps, 'PROFILE_STEPS', 0))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError('CUDA is not available; pass device="cpu" '
                                   'to profile on the CPU')
            device = torch.device('cuda', torch.cuda.current_device())
        self.device = torch.device(device)
        self.active = False
        self.done = False
        self._prof = None

    @property
    def enabled(self) -> bool:
        return bool(self.trace_dir)

    def step(self, it: int) -> None:
        """Call once per dispatch with its first iteration number."""
        if not self.enabled or self.done:
            return
        if not self.active and self.start <= it < self.start + self.num_steps:
            os.makedirs(self.trace_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.trace_dir))
            self._prof.start()
            self.active = True
            print('profiler: tracing steps [{}, {}) -> {}'.format(
                it, self.start + self.num_steps, self.trace_dir), flush=True)
        elif self.active and it >= self.start + self.num_steps:
            self._stop()

    def _stop(self) -> None:
        if self.device.type == 'cuda':
            # the window's kernels finish before the trace is cut
            torch.cuda.synchronize(self.device)
        self._prof.stop()              # writes the trace file
        self._prof = None
        self.active = False
        self.done = True
        print('profiler: trace written to {}'.format(self.trace_dir),
              flush=True)

    def close(self) -> None:
        if self.active:
            self._stop()
