"""Where a step of the bf16 LSTM forward kernels' cluster recurrence goes.

Builds copies of ``csrc/lstm_fwd.cu`` (kernel 5, H = 512) and
``csrc/bilstm_fwd.cu`` (kernel 1, H = 256, both directions) with parts of
the step of their shared recurrence (``csrc/lstm_fwd_cluster.cuh``) taken
out, and times each copy's cluster kernel on the device at batch 64, T = 23
and T = 111, residuals off (the decode path's call):

* ``full``: the kernels as they are;
* ``local_pull``: each block pulls its own h slice CS times (the same loads
  from its own shared memory) instead of the cluster's;
* ``no_cluster_barrier``: the step's cluster barrier becomes a block
  barrier (one cluster barrier at the end keeps the last pulls safe);
* ``no_product``: the step's tensor-core product is skipped;
* ``gates_only``: all three taken out, leaving the gate math, the stores
  and the block barriers;
* ``arrive_after_stores``: the barrier's arrive moved after the global
  stores of out and the residuals, so its release covers them too (the
  order before the barrier was split).

The copies but ``full`` and ``arrive_after_stores`` compute wrong outputs
on purpose: only their times mean anything. Each line is the device time of
the cluster kernel (median over ``torch.profiler`` passes of 20 calls) and
its time per step::

    python -m lstm_ctc_ocr_torch.tools.ablate_lstm_fwd

Needs the GPU machine (nvcc and a card); the copies are built under the
ignored ``lstm_ctc_ocr_torch/build/ablate/``.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from ..engine.test import resolve_device
from ..ops import _build, rnn_cuda
from .ablate_lstm_bwd import build_variants, card_name, recurrence_ms

HEADER = 'lstm_fwd_cluster.cuh'
_PULL = 'cluster.map_shared_rank(h_s, src)'
_ARRIVE = '    arrive_cluster();\n'
_WAIT = '    wait_cluster();\n'
_END = '      __syncthreads();\n    }\n  }\n}\n'
_PRODUCT = 'if (i >= per || ks >= n_steps) break;'
ABLATIONS = {
    'full': [],
    'local_pull': [(_PULL, 'h_s')],
    'no_cluster_barrier': [(_ARRIVE, '    __syncthreads();\n'), (_WAIT, ''),
                           (_END, _END[:-2] + '  cluster.sync();\n}\n')],
    'no_product': [(_PRODUCT, 'break;')],
    'arrive_after_stores': [(_ARRIVE, ''), (_WAIT, _ARRIVE + _WAIT)],
}
ABLATIONS['gates_only'] = (ABLATIONS['local_pull']
                           + ABLATIONS['no_cluster_barrier']
                           + ABLATIONS['no_product'])

# wrapper (in rnn_cuda) -> (hidden size, its cluster kernel)
KERNELS = {'lstm_fwd': (512, 'lstm_fwd_cluster_kernel'),
           'bilstm_fwd': (256, 'bilstm_fwd_cluster_kernel')}


def forward_args(name, t_len, n, h, device, seed=7):
    """The wrapper's inputs at one shape from seeded inputs, lengths near T
    as an eval bucket's."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device,
                                                            torch.bfloat16)
    lens = torch.randint(max(1, t_len - 8), t_len + 1, (n,), generator=g)
    lens = lens.to(device, torch.int32)
    dirs = 1 if name == 'lstm_fwd' else 2
    weights = []
    for _ in range(dirs):
        weights.append((rnd(t_len, n, 4 * h), rnd(h, 4 * h, scale=h ** -0.5),
                        rnd(4 * h, scale=0.1)))
    if dirs == 1:
        return weights[0] + (lens,)
    (xf, uf, bf), (xb, ub, bb) = weights
    return xf, xb, uf, ub, bf, bb, lens


def main():
    resolve_device('cuda')
    card = card_name()
    builds = {name: build_variants(name, HEADER, ABLATIONS)
              for name in KERNELS}
    try:
        for name, (h, kernel) in KERNELS.items():
            for t_len in (23, 111):
                args = forward_args(name, t_len, 64, h, 'cuda')
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
