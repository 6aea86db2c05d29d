"""What the measurement tools share: the port's own copies of the pieces
the JAX package's tools take from the repo-root ``bench.py``
(:func:`build_batches`, the peak lookup :func:`peak_flops_for`), the timing
discipline of those tools (:func:`timed_ms`), the FLOP count of a call
(:func:`count_flops`), the kernel launch counters (:func:`launch_counts`)
and the TF interop tools' import of tensorflow (:func:`import_tensorflow`).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..data.gen import bucket_batch, generate_img
from ..ops import ctc_cuda, rnn_cuda

# Peak dense bf16 tensor-core rate per card, FLOP/s (NVIDIA's data sheet,
# SXM part at its 700 W limit): the MFU denominator. An unknown card gives
# None (printed as null) rather than a guess.
PEAK_BF16_FLOPS = {
    'NVIDIA H100 80GB HBM3': 989e12,
}

# the wrappers of the hand kernels the tools' model runs (kernels 1-4), by
# the names the kernel table uses
KERNELS = {'bilstm_fwd': rnn_cuda.bilstm_fwd,
           'bilstm_bwd': rnn_cuda.bilstm_bwd,
           'ctc_fwd': ctc_cuda.ctc_forward, 'ctc_bwd': ctc_cuda.ctc_backward}

# f32 operations per (example, frame, state) of a CTC recursion: three exp,
# one log, adds and maxima (chip_smoke.py's bound counts the same)
CTC_OPS_PER_STATE = 14


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or 'cpu'."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def peak_flops_for(device_kind: str):
    """The card's peak bf16 FLOP/s by the longest matching name prefix, or
    None for a card (or the CPU) not in the table."""
    best = None
    for kind, peak in PEAK_BF16_FLOPS.items():
        if device_kind.startswith(kind) and (best is None
                                            or len(kind) > len(best[0])):
            best = (kind, peak)
    return best[1] if best else None


def build_batches(cfg, batch, width, n_batches=4, seed=0):
    """``n_batches`` rendered batches of ``batch`` captchas (the renderer of
    ``cfg.RENDERER``), each padded to the one bucket ``width``: what the JAX
    tools pre-render and cycle. Returns ``data/gen.DeviceBatch``es."""
    rng = random.Random(seed)
    batches = []
    for _ in range(n_batches):
        imgs, labels = [], []
        for _ in range(batch):
            im, lab = generate_img(cfg, rng)
            imgs.append(im)
            labels.append(lab)
        batches.append(bucket_batch(imgs, labels, cfg, buckets=[width]))
    return batches


def readback(out):
    """Copy one element of ``out``'s first tensor (or array) to the host: a
    synchronising read that closes a timing window, as the JAX tools close
    theirs."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor):
        return float(out.reshape(-1)[0])
    return float(np.asarray(out).ravel()[0])


def timed_ms(fn, *args, windows=9, calls=50, device='cpu'):
    """Median ms per call of ``fn(*args)`` over ``windows`` windows of
    ``calls`` calls, after one warm call. Each window ends with a
    synchronising readback of the last call's result; on a CUDA device the
    window is timed by CUDA events recorded around its calls, on the CPU by
    the host clock up to the readback."""
    readback(fn(*args))
    cuda = torch.device(device).type == 'cuda'
    rates = []
    for _ in range(windows):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        if cuda:
            end.record()
        readback(out)
        if cuda:
            rates.append(start.elapsed_time(end) / calls)
        else:
            rates.append((time.perf_counter() - t0) / calls * 1e3)
    rates.sort()
    return rates[len(rates) // 2]


def launch_counts():
    """Each hand kernel's launches so far."""
    return {name: w.launches for name, w in KERNELS.items()}


def kernel_flops(live_steps, hidden, n, t_len, s_len):
    """FLOPs of one launch of each hand kernel of :data:`KERNELS`, the work
    ``FlopCounterMode`` cannot see inside them: the recurrent product h·U,
    ``2 * live_steps * H * 4H`` a direction forward and twice that backward
    (``live_steps`` the batch's valid frames, ``H`` a direction's units),
    and ``CTC_OPS_PER_STATE`` a state a frame an example for each CTC
    recursion over ``[n, t_len, s_len]``."""
    direction = 2 * int(live_steps) * hidden * 4 * hidden
    ctc = CTC_OPS_PER_STATE * n * t_len * s_len
    return {'bilstm_fwd': 2 * direction, 'bilstm_bwd': 4 * direction,
            'ctc_fwd': ctc, 'ctc_bwd': ctc}


def count_flops(fn, *args, per_launch=None):
    """FLOPs of one call of ``fn(*args)``: ``FlopCounterMode``'s count of the
    library convolutions and matrix products, plus ``per_launch[name]`` for
    each launch of a hand kernel the call makes (:func:`kernel_flops`).
    On the CPU no kernel launches; the counter sees the plain versions'
    products instead. The call runs once, for real."""
    before = launch_counts()
    with FlopCounterMode(display=False) as counter:
        readback(fn(*args))
    after = launch_counts()
    extra = sum((per_launch or {}).get(k, 0) * (after[k] - before[k])
                for k in after)
    return counter.get_total_flops() + extra


def import_tensorflow(tool: str):
    """``tensorflow``, imported when a TF interop tool needs it (its C++
    logs quieted, as the JAX tools do); where it does not import, an
    ``ImportError`` that names it and ``tool``."""
    os.environ.setdefault('TF_CPP_MIN_LOG_LEVEL', '3')
    try:
        import tensorflow
    except ImportError as e:
        raise ImportError(
            '{} needs tensorflow, which does not import here ({}); install '
            'tensorflow to read or write TF files'.format(tool, e)) from e
    return tensorflow
