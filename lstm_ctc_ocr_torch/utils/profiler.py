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
the trace as one graph launch, not as the kernels of its K steps.

Usage in a loop::

    prof = StepProfiler(cfg=cfg, device=dev)  # no-op unless PROFILE_DIR
    for it in ...:
        prof.step(it)              # starts/stops the trace at the window
    prof.close()                   # safety stop on early exit

Tracing changes no number the steps compute.
"""

from __future__ import annotations

import os

import torch


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
