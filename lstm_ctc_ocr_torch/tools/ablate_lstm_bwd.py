"""Where a step of the bf16 LSTM backward kernels' cluster recurrence goes.

Builds copies of ``csrc/lstm_bwd.cu`` (kernel 6, H = 512) and
``csrc/bilstm_bwd.cu`` (kernel 2, H = 256, both directions) with parts of
the step of their shared recurrence (``csrc/lstm_bwd_cluster.cuh``) taken
out, and times each copy's cluster kernel on the device at batch 64,
T = 23 and T = 111:

* ``full``: the kernels as they are;
* ``local_reads``: each block adds its own partial products (the same loads
  from its own shared memory) instead of the cluster's;
* ``no_cluster_barrier``: the step's cluster barrier becomes a block
  barrier;
* ``no_product``: the step's tensor-core product is skipped;
* ``dg_only``: all three taken out, leaving the gate math, dx and the block
  barrier.

The copies compute wrong gradients on purpose: only their times mean
anything. Each line is the device time of the recurrence kernel (median
over ``torch.profiler`` passes of 20 calls) and its time per step::

    python -m lstm_ctc_ocr_torch.tools.ablate_lstm_bwd

Needs the GPU machine (nvcc and a card); the copies are built under the
ignored ``lstm_ctc_ocr_torch/build/ablate/``. ``tools/ablate_lstm_fwd.py``
does the same for the forward kernels' cluster recurrence.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from ..engine.test import resolve_device
from ..ops import _build, rnn_cuda

HEADER = 'lstm_bwd_cluster.cuh'
_BARRIER = '    cluster.sync();\n\n    // dh[r, k]'
_REMOTE = 'cluster.map_shared_rank(p_out, b);'
_PRODUCT = 'if (warp * 4 < n_tiles) {'
ABLATIONS = {
    'full': [],
    'local_reads': [(_REMOTE, 'p_out;')],
    'no_cluster_barrier': [(_BARRIER, _BARRIER.replace('cluster.sync()',
                                                       '__syncthreads()'))],
    'no_product': [(_PRODUCT, 'if (false) {')],
}
ABLATIONS['dg_only'] = (ABLATIONS['local_reads']
                        + ABLATIONS['no_cluster_barrier']
                        + ABLATIONS['no_product'])

# wrapper (in rnn_cuda) -> (hidden size, its cluster kernel)
KERNELS = {'lstm_bwd': (512, 'lstm_bwd_cluster_kernel'),
           'bilstm_bwd': (256, 'bilstm_bwd_cluster_kernel')}


def build_variants(source='lstm_bwd', edited=HEADER, ablations=None):
    """Compile ``csrc/<source>.cu`` once per variant, with the variant's
    edits applied to ``csrc/<edited>`` (the source or a header it
    includes), one nvcc each, all at once: name -> .so."""
    ablations = ABLATIONS if ablations is None else ablations
    with open(os.path.join(_build.SRC_DIR, edited)) as f:
        original = f.read()
    procs = {}
    for name, edits in ablations.items():
        text = original
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError('ablation {}: {!r} is not in {} exactly '
                                   'once'.format(name, old, edited))
            text = text.replace(old, new)
        out = os.path.join(_build.BUILD_DIR, 'ablate', source, name)
        os.makedirs(out, exist_ok=True)
        for fname in os.listdir(_build.SRC_DIR):
            if fname.endswith('.cuh') or fname == source + '.cu':
                shutil.copy(os.path.join(_build.SRC_DIR, fname), out)
        with open(os.path.join(out, edited), 'w') as f:
            f.write(text)
        so = os.path.join(out, 'lib{}.so'.format(source))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + ['-o', so, os.path.join(out, source + '.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (_, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for {}:\n{}'.format(
                name, log.decode(errors='replace')))
    return {name: so for name, (so, _) in procs.items()}


def backward_args(t_len, n, h, device, seed=7, name='lstm_bwd'):
    """The inputs of wrapper ``name`` (``lstm_bwd`` or ``bilstm_bwd``) at one
    shape: its forward kernel's residuals from seeded inputs (lengths near
    T, as an eval bucket's) and cotangents."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device,
                                                            torch.bfloat16)
    lens = torch.randint(max(1, t_len - 8), t_len + 1, (n,), generator=g)
    lens = lens.to(device, torch.int32)
    if name == 'lstm_bwd':
        u = rnd(h, 4 * h, scale=h ** -0.5)
        _, gates, hs, cs = rnn_cuda.lstm_fwd(rnd(t_len, n, 4 * h), u,
                                             rnd(4 * h, scale=0.1), lens,
                                             save_residuals=True)
        return rnd(t_len, n, h, scale=0.1), gates, hs, cs, u, lens
    uf, ub = rnd(h, 4 * h, scale=h ** -0.5), rnd(h, 4 * h, scale=h ** -0.5)
    _, gf, hf, cf, _, gb, hb, cb = rnn_cuda.bilstm_fwd(
        rnd(t_len, n, 4 * h), rnd(t_len, n, 4 * h), uf, ub,
        rnd(4 * h, scale=0.1), rnd(4 * h, scale=0.1), lens,
        save_residuals=True)
    return (rnd(t_len, n, h, scale=0.1), rnd(t_len, n, h, scale=0.1), gf, hf,
            cf, gb, hb, cb, uf, ub, lens)


def recurrence_ms(args, passes=3, reps=20, fn=None,
                  kernel='lstm_bwd_cluster_kernel'):
    """Median over ``passes`` profiler passes of the device time per call of
    ``fn`` (default ``rnn_cuda.lstm_bwd``) spent in ``kernel``, or None when
    the profiler sees no device time."""
    fn = fn or rnn_cuda.lstm_bwd
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    times = []
    for _ in range(passes):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in e.key)
        if total > 0:
            times.append(total / 1e3 / reps)
    return sorted(times)[len(times) // 2] if times else None


def card_name():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main():
    resolve_device('cuda')
    card = card_name()
    builds = {name: build_variants(name) for name in KERNELS}
    try:
        for name, (h, kernel) in KERNELS.items():
            for t_len in (23, 111):
                args = backward_args(t_len, 64, h, 'cuda', name=name)
                for variant, so in builds[name].items():
                    _build._loaded[name] = ctypes.CDLL(so)
                    ms = recurrence_ms(args, fn=getattr(rnn_cuda, name),
                                       kernel=kernel)
                    print(json.dumps({
                        'kernel': name, 'variant': variant, 't': t_len,
                        'n': 64, 'h': h, 'recurrence_device_ms': ms,
                        'us_per_step': 1e3 * ms / t_len if ms else None,
                        'device': card}), flush=True)
                _build._loaded.pop(name, None)
    finally:
        for name in KERNELS:
            _build._loaded.pop(name, None)
    return 0


if __name__ == '__main__':
    sys.exit(main())
