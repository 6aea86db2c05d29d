"""A/B: the fused conv3x3+BN+ReLU CUDA kernel against the unfused layer.

Counterpart of the JAX package's ``tools/bench_conv_bn.py``. Times the
FORWARD of conv4_1 / conv4_2 at their real geometry (W=96 bucket -> W/4 = 24,
H = 4) through ``ops/conv_bn_cuda.conv3x3_bn_relu`` (``csrc/conv_bn.cu``) and
through ``models/layers.ConvSingle(bn=True)`` (cuDNN conv, then bias, batch
norm and ReLU as separate torch ops), and holds the fused result against its
plain version and against the unfused layer. One JSON line per shape and
implementation; times are medians of CUDA-event timings.

    python -m lstm_ctc_ocr_torch.tools.bench_conv_bn [--batch 64]
        [--dtype bfloat16|float32] [--device cpu]

The device is CUDA unless ``--device cpu`` is given; on the CPU the wrapper
takes its plain version, so the run checks the plumbing only and prints no
time (``ms`` is null).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..engine.test import full_f32, resolve_device
from ..models.layers import ConvSingle
from ..ops import conv_bn_cuda

# (tag, W, H, C_in, C_out) of the two batch-norm convs of the CRNN
SHAPES = [('conv4_1', 24, 4, 256, 512), ('conv4_2', 24, 4, 512, 512)]
_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def make_case(n, w, h, ci, co, dtype, device, seed=0):
    """Seeded inputs in the port's layout: ``x`` [N, C_in, W, H] in ``dtype``
    and f32 parameters ``kernel`` [C_out, C_in, 3, 3], ``bias``, ``gamma``,
    ``beta`` [C_out]."""
    rng = np.random.RandomState(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale + shift).astype(np.float32)).to(device)
    return {'x': rnd(n, ci, w, h).to(dtype),
            'kernel': rnd(co, ci, 3, 3, scale=0.05),
            'bias': rnd(co, scale=0.1), 'gamma': rnd(co, scale=0.1, shift=1.0),
            'beta': rnd(co, scale=0.1)}


def fused_args(case):
    return (case['x'], case['kernel'], case['bias'], case['gamma'],
            case['beta'])


def unfused_layer(case):
    """``ConvSingle(bn=True)`` carrying the case's parameters; call it as
    ``layer(x, dtype)`` with ``dtype`` None for f32."""
    co, ci = case['kernel'].shape[:2]
    layer = ConvSingle(ci, co, 3, bn=True).to(case['kernel'].device)
    with torch.no_grad():
        layer.kernel.copy_(case['kernel'])
        layer.biases.copy_(case['bias'])
        layer.bn_gamma.copy_(case['gamma'])
        layer.bn_beta.copy_(case['beta'])
    return layer


def event_ms(fn, reps=50, warmup=5):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@torch.no_grad()
def run(tag, n, w, h, ci, co, dtype=torch.bfloat16, device='cuda', reps=50):
    """The A/B at one shape: two result rows (``impl`` 'unfused' and
    'fused'), each with its time (null on the CPU), its rate and its largest
    difference from the unfused layer relative to that layer's largest
    output; the fused row also carries ``max_abs_err_vs_plain``."""
    dev = torch.device(device)
    case = make_case(n, w, h, ci, co, dtype, dev)
    layer = unfused_layer(case)
    layer_dtype = None if dtype == torch.float32 else dtype
    x32 = case['x'].float()
    impls = (
        ('unfused', lambda: layer(x32, layer_dtype)),
        ('fused', lambda: conv_bn_cuda.conv3x3_bn_relu(*fused_args(case))))
    want = impls[0][1]().float()
    plain = conv_bn_cuda.conv3x3_bn_relu_reference(*fused_args(case)).float()
    flops = 2 * n * w * h * co * ci * 9
    rows = []
    for impl, fn in impls:
        got = fn().float()
        ms = event_ms(fn, reps) if dev.type == 'cuda' else None
        row = {'shape': tag, 'n': n, 'w': w, 'h': h, 'ci': ci, 'co': co,
               'dtype': str(dtype).split('.')[-1], 'impl': impl, 'ms': ms,
               'tflops': flops / ms / 1e9 if ms else None,
               'rel_err_vs_unfused': float(
                   (got - want).abs().max() / want.abs().max().clamp(min=1e-6)),
               'device': (torch.cuda.get_device_name(dev)
                          if dev.type == 'cuda' else 'cpu')}
        if impl == 'fused':
            row['max_abs_err_vs_plain'] = float((got - plain).abs().max())
        rows.append(row)
    return rows


@full_f32()
def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Fused conv3x3+BN+ReLU kernel vs the unfused layer')
    parser.add_argument('--batch', type=int, default=64)
    parser.add_argument('--dtype', default='bfloat16', choices=sorted(_DTYPES))
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    for tag, w, h, ci, co in SHAPES:
        for row in run(tag, args.batch, w, h, ci, co, _DTYPES[args.dtype],
                       dev):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
