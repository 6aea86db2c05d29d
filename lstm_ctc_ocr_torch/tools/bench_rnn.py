"""Micro-benchmark: the fused BiLSTM kernels against the two-scan pair.

Counterpart of the JAX package's ``tools/bench_rnn.py``, with its flags,
defaults and JSON keys. Times the recurrence the longline config is bound
by (wide buckets, long frame sequences), forward and forward+backward (the
gradient of the input and of every weight), median ms a call:

* ``impl`` 'scan_pair': ``ops/rnn.py:bilstm_scan_pair``, two plain masked
  scans and two reversal gathers in PyTorch;
* ``impl`` 'fused': ``ops/rnn.py:bilstm``, one input projection, then the
  fused forward kernel (``csrc/bilstm_fwd.cu``) and, for the gradient, the
  fused backward kernel (``csrc/bilstm_bwd.cu``).

then the speedup line. Shapes default to the longline hot bucket,
``[32, 191, 512]`` with H=256 a direction, in bf16. Run::

    python -m lstm_ctc_ocr_torch.tools.bench_rnn [--device cpu]

On the CPU the 'fused' rows run the kernels' plain versions: a check of
the plumbing.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..engine.test import full_f32, resolve_device
from ..models.layers import LSTMCell
from ..ops import rnn
from ._common import device_name, timed_ms


def make_cells(input_dim, hidden, dtype, device, seed=0):
    """Both directions' weights ``{'fw'|'bw': {'w', 'u', 'bias'}}`` in the
    layer's initialisation, in ``dtype`` on ``device``, each needing a
    gradient."""
    g = torch.Generator().manual_seed(seed)
    return {d: {k: p.detach().to(device, dtype).requires_grad_()
                for k, p in (('w', c.w), ('u', c.u), ('bias', c.bias))}
            for d, c in (('fw', LSTMCell(input_dim, hidden, g)),
                         ('bw', LSTMCell(input_dim, hidden, g)))}


@full_f32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--frames', type=int, default=191)
    ap.add_argument('--input-dim', type=int, default=512)
    ap.add_argument('--hidden', type=int, default=256)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--windows', type=int, default=7)
    ap.add_argument('--calls', type=int, default=10)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dt = getattr(torch, args.dtype)

    cells = make_cells(args.input_dim, args.hidden, dt, dev)
    weights = [p for c in cells.values() for p in c.values()]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(args.batch, args.frames, args.input_dim)
                         .astype(np.float32)).to(dev, dt).requires_grad_()
    lens = torch.from_numpy(rng.randint(
        args.frames // 2, args.frames + 1,
        size=(args.batch,)).astype(np.int32)).to(dev)
    timing = dict(windows=args.windows, calls=args.calls, device=dev)

    results = {}
    for name, impl in (('scan_pair', rnn.bilstm_scan_pair),
                       ('fused', rnn.bilstm)):
        def fwd(xx, f=impl):
            with torch.no_grad():
                return f(cells, xx, lens)

        def fwd_bwd(xx, f=impl):
            out = f(cells, xx, lens).float().sum()
            return torch.autograd.grad(out, [xx] + weights)[0]
        results[name] = {'fwd_ms': timed_ms(fwd, x, **timing),
                         'fwd_bwd_ms': timed_ms(fwd_bwd, x, **timing)}
        print(json.dumps({'impl': name,
                          **{k: round(v, 3) for k, v in results[name].items()},
                          'shape': [args.batch, args.frames, args.input_dim],
                          'hidden': args.hidden, 'dtype': args.dtype,
                          'device': device_name(dev)}), flush=True)
    sp, fu = results['scan_pair'], results['fused']
    print(json.dumps({
        'speedup_fwd': round(sp['fwd_ms'] / fu['fwd_ms'], 3),
        'speedup_fwd_bwd': round(sp['fwd_bwd_ms'] / fu['fwd_bwd_ms'], 3)}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
