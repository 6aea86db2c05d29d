"""What the benchmark's drivers share: the files of a cell, the inputs made
from the seed, the weights handed to both sides, the host spans, the
card's identity, and the comparison's helpers.

Everything here reads and writes inside the checkout: the decoded PNGs
are cached under ``.bench_cache/`` at its root (listed in ``.gitignore``),
at a fixed path, so that only a checkout's first run decodes them.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np

from .reference import png

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(REPO, '.bench_cache')


def process_start() -> float:
    """The ``time.time()`` at which this process started, from
    ``/proc/self/stat`` and the boot time (10 ms resolution); the module's
    import time where ``/proc`` is missing."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith('btime'))
        return boot + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, StopIteration, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def repo_path(path):
    """A path of the checkout, given relative to its root."""
    return os.path.join(REPO, path)


def load_json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_cell(name):
    """The workload file of cell ``name`` and its configuration's file."""
    path = os.path.join(BENCH_DIR, 'workloads', name + '.json')
    if not os.path.isfile(path):
        raise SystemExit('no workload file {}'.format(path))
    work = load_json('workloads', name + '.json')
    config = load_json('configs', work['config'] + '.json')
    return work, config


def card():
    """``(name, power limit)`` of the first card, as nvidia-smi reads
    them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(',', 1)
    return name.strip(), limit.strip()


def port_cfg(config):
    """The program's config object with the configuration file's ``cfg``
    merged over its defaults, as a ``--set`` on the command line would."""
    from lstm_ctc_ocr_torch.config import default_cfg, merge_a_into_b
    cfg = default_cfg()
    merge_a_into_b(config['cfg'], cfg)
    return cfg


def model_dims(config):
    c = config['cfg']
    return dict(nchannels=1, num_hid=int(c['TRAIN']['NUM_HID']),
                nclasses=int(c['NCLASSES']))


# ---- inputs ---------------------------------------------------------------

def load_images(data_dir, height):
    """The labelled PNGs ``{idx}_{label}.png`` of ``data_dir`` (a path
    relative to the checkout), sorted by name: ``(labels, raw gray uint8
    [H, W] images, images resized to ``height`` [height, w])``. Decoded
    once per checkout and cached."""
    names = sorted(f for f in os.listdir(os.path.join(REPO, data_dir))
                   if f.endswith('.png'))
    key = '{}-{}-{}'.format(data_dir.strip('/').replace('/', '_'), height,
                            len(names))
    path = os.path.join(CACHE_DIR, key + '.npz')
    if os.path.isfile(path):
        with np.load(path, allow_pickle=False) as z:
            if list(z['names']) == names:
                raw = [z['raw_{}'.format(i)] for i in range(len(names))]
                res = [z['res_{}'.format(i)] for i in range(len(names))]
                return labels_of(names), raw, res
    raw = [png.load_image(os.path.join(REPO, data_dir, f)) for f in names]
    res = [png.resize_linear(im, int(height / im.shape[0] * im.shape[1]),
                             height) if im.shape[0] != height else im
           for im in raw]
    os.makedirs(CACHE_DIR, exist_ok=True)
    arrays = {'names': np.array(names)}
    arrays.update({'raw_{}'.format(i): a for i, a in enumerate(raw)})
    arrays.update({'res_{}'.format(i): a for i, a in enumerate(res)})
    tmp = path + '.part.npz'
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return labels_of(names), raw, res


def labels_of(names):
    return [os.path.splitext(f)[0].split('_', 1)[1] for f in names]


def pick_bucket(width, buckets):
    for b in sorted(buckets):
        if b >= width:
            return int(b)
    raise ValueError('width {} exceeds the largest bucket {}'.format(
        width, max(buckets)))


def encode(label, charset):
    return [charset.index(c) + 1 for c in label]


# ---- spans ----------------------------------------------------------------

class Spans:
    """Host spans of the benchmark's own calls into the program's layers:
    ``(name, start_ns, end_ns, parent index)``, kept in memory. With
    ``annotate`` each span is also a ``torch.profiler.record_function``
    range, so the profiler's trace can say what the host was doing in a
    device gap."""

    def __init__(self, annotate=False):
        self.rows = []
        self.annotate = annotate
        self._open = []

    @contextlib.contextmanager
    def __call__(self, name):
        parent = self._open[-1] if self._open else -1
        idx = len(self.rows)
        self.rows.append([name, time.perf_counter_ns(), None, parent])
        self._open.append(idx)
        try:
            if self.annotate:
                import torch
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            self._open.pop()
            self.rows[idx][2] = time.perf_counter_ns()

    def write(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as f:
            json.dump({'spans': self.rows}, f)


# ---- comparison -----------------------------------------------------------

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a bias ahead of batch norm): Adam moves it by
# round-off alone, so its change is not compared
ZERO_GRAD_SHARE = 1e-3


def quiet_leaves(ref_grads):
    """The leaves whose reference gradient (here Adam's first moment) is
    under ``ZERO_GRAD_SHARE`` of the median leaf's."""
    norms = {k: float(v.float().norm()) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return {k for k, v in norms.items() if v < ZERO_GRAD_SHARE * med}


def leaf_gaps(prog, ref, skip=()):
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's.
    Leaves in ``skip`` are left out."""
    keys = [k for k in ref if k not in skip]
    ref_n = {k: float(ref[k].float().norm()) for k in keys}
    med = statistics.median(ref_n.values())
    return {k: abs(float(prog[k].float().norm()) - ref_n[k]) / max(ref_n[k],
                                                                    med)
            for k in keys}


def leaf_gap(prog, ref, skip=()):
    """The worst leaf's :func:`leaf_gaps`: ``(gap, leaf)``."""
    gaps = leaf_gaps(prog, ref, skip)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
