"""A/B: fold the collapsed H axis into channels for the late conv stack.

Counterpart of the JAX package's ``tools/bench_fold_h.py``, with its flags,
defaults and JSON keys, in the port's ``[N, C, W, H]`` layout with cuDNN's
convolutions (the JAX tool uses XLA's; neither is a hand kernel). The late
convs (conv4_1 -> conv4_2 -> pool3 -> conv5) run at H in {4, 2}; the folded
path lowers them to H = 1 with H in the channel axis, channel ``h * C + c``:

* conv4_x (3x3 SAME over [W, H=4]) becomes a 3x1 conv with a
  block-tridiagonal ``[4*Co, 4*Ci]`` kernel built inside the call, 1.33x the
  FLOPs (12 H-blocks where the tridiagonal needs 10);
* batch norm and ReLU take per-Co statistics over a free view of the
  folded tensor, as ``models/layers.py``'s BN computes them;
* pool3 (1x2 over H) is a max over adjacent channel blocks;
* conv5 (2x2 VALID at H=2) folds exactly into a 2x1 conv with the
  ``[Co, 2*Ci]`` reshaped kernel.

Both paths take one set of parameters (``make_params``, the JAX tool's
draws, or :func:`params_from_hwio` of JAX's arrays), and the fold happens
inside the call, so the backward pays the same reshapes. The two are first
held equal in f32 (``rel_err < 1e-4``, TF32 off as the JAX tool pins f32
precision), then timed in bf16, forward and forward+backward (the gradient
of the parameters), median of ``--windows`` windows of ``--calls`` calls,
each window closed by a synchronising readback and timed by CUDA events on
the card. Run::

    python -m lstm_ctc_ocr_torch.tools.bench_fold_h [--batch 256]
        [--width 24] [--check-only] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.test import full_f32, resolve_device
from ..models.layers import BN_EPS
from ._common import timed_ms


def params_from_hwio(params, device='cpu'):
    """The JAX tool's parameter dict (HWIO kernels ``[kW, kH, Ci, Co]``,
    numpy or arrays) in the port's layout: kernels ``[Co, Ci, kW, kH]``,
    f32 tensors on ``device``."""
    out = {}
    for name, p in params.items():
        out[name] = {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                     device=device) for k, v in p.items()}
        out[name]['kernel'] = out[name]['kernel'].permute(3, 2, 0, 1) \
            .contiguous()
    return out


def make_params(rng, device='cpu'):
    """The JAX tool's parameters from the same numpy draws, in the port's
    layout."""
    def k(*shape, scale=0.05):
        return rng.randn(*shape).astype(np.float32) * scale
    return params_from_hwio({
        'conv4_1': {'kernel': k(3, 3, 256, 512), 'biases': np.zeros(512),
                    'bn_gamma': np.ones(512), 'bn_beta': np.zeros(512)},
        'conv4_2': {'kernel': k(3, 3, 512, 512), 'biases': np.zeros(512),
                    'bn_gamma': np.ones(512), 'bn_beta': np.zeros(512)},
        'conv5': {'kernel': k(2, 2, 512, 512), 'biases': np.zeros(512)},
    }, device)


def _per_channel(v):
    return v.reshape(1, -1, 1, 1)


def bn_relu(y, gamma, beta, dims=(0, 2, 3), relu=True):
    """The production BN (``models/layers.py``, ``bn=True``): f32 batch
    statistics over ``dims`` (biased variance, eps 1e-3), then ReLU, in
    ``y``'s dtype; ``gamma`` and ``beta`` broadcast against ``y``."""
    dt = y.dtype
    y32 = y.float()
    mean = y32.mean(dim=dims, keepdim=True)
    var = y32.var(dim=dims, unbiased=False, keepdim=True)
    y = ((y32 - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta).to(dt)
    return torch.relu(y) if relu else y


def conv(x, kernel, padding):
    return F.conv2d(x, kernel.to(x.dtype), padding=padding)


def late_stack_baseline(params, x):
    """conv4_1, conv4_2 (BN, ReLU), pool3 and conv5 at the production
    geometry: x [N, 256, W, 4] -> [N, 512, W-1, 1]."""
    for name in ('conv4_1', 'conv4_2'):
        p = params[name]
        x = bn_relu(conv(x, p['kernel'], 1)
                    + _per_channel(p['biases']).to(x.dtype),
                    _per_channel(p['bn_gamma']), _per_channel(p['bn_beta']))
    x = F.max_pool2d(x, (1, 2), (1, 2))                        # pool3
    p = params['conv5']
    return conv(x, p['kernel'], 0) + _per_channel(p['biases']).to(x.dtype)


def fold_tridiag(kernel, hn):
    """``[Co, Ci, kW, 3]`` SAME-over-H conv kernel -> ``[hn*Co, hn*Ci, kW,
    1]`` block-tridiagonal folded kernel: output block h reads input block
    hp through ``kernel[..., hp - h + 1]`` (zero outside the 3-tap
    window)."""
    co, ci, kw, kh = kernel.shape
    zero = kernel.new_zeros(co, ci, kw)
    rows = [torch.cat([kernel[..., hp - h + 1] if 0 <= hp - h + 1 < kh
                       else zero for hp in range(hn)], dim=1)
            for h in range(hn)]                         # [Co, hn*Ci, kW]
    return torch.cat(rows, dim=0)[..., None]


def late_stack_folded(params, x):
    """The same function as :func:`late_stack_baseline` with H folded into
    the channels: x [N, Ci, W, Hn] -> [N, 512, W-1, 1]."""
    n, ci, w, hn = x.shape
    xf = x.permute(0, 3, 1, 2).reshape(n, hn * ci, w, 1)  # fold H in
    for name in ('conv4_1', 'conv4_2'):
        p = params[name]
        co = p['kernel'].shape[0]
        y = conv(xf, fold_tridiag(p['kernel'], hn), (1, 0)) \
            + _per_channel(p['biases'].repeat(hn)).to(xf.dtype)
        # per-Co statistics over (N, H, W): a free view of the folded layout
        y = bn_relu(y.view(n, hn, co, w), p['bn_gamma'].view(1, 1, co, 1),
                    p['bn_beta'].view(1, 1, co, 1), dims=(0, 1, 3))
        xf = y.reshape(n, hn * co, w, 1)
    y = torch.maximum(y[:, 0::2], y[:, 1::2])            # pool3 over H blocks
    hn //= 2
    xf = y.reshape(n, hn * co, w, 1)
    p = params['conv5']
    k5 = p['kernel'].permute(0, 3, 1, 2).reshape(p['kernel'].shape[0],
                                                 hn * co, -1, 1)
    return conv(xf, k5, 0) + _per_channel(p['biases']).to(xf.dtype)


def rel_err(a, b):
    """max |a - b| / max |a|, in f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


@full_f32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--width', type=int, default=24,
                    help='post-pool W (the default bucket W=96 -> 24)')
    ap.add_argument('--check-only', action='store_true')
    ap.add_argument('--windows', type=int, default=9)
    ap.add_argument('--calls', type=int, default=8)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    params = make_params(rng, dev)
    n, w = args.batch, args.width

    # the f32 equivalence gate at a small batch; TF32 is off (full_f32), as
    # the JAX tool pins f32 matmul precision, so a miss is layout, not
    # numerics
    x32 = torch.from_numpy(rng.randn(8, w, 4, 256).astype(np.float32)) \
        .permute(0, 3, 1, 2).contiguous().to(dev)
    with torch.no_grad():
        a = late_stack_baseline(params, x32)
        b = late_stack_folded(params, x32)
    if a.shape != b.shape:
        raise RuntimeError('folded shape {} != baseline {}'.format(
            tuple(b.shape), tuple(a.shape)))
    err = rel_err(a, b)
    print(json.dumps({'check': 'fold_h equivalence', 'rel_err': err,
                      'shape': list(a.shape)}), flush=True)
    if not err < 1e-4:
        raise RuntimeError('fold_h equivalence: rel_err {} >= 1e-4'
                           .format(err))
    if args.check_only:
        return 0

    x = torch.from_numpy(rng.randn(n, w, 4, 256).astype(np.float32)) \
        .permute(0, 3, 1, 2).contiguous().to(dev, torch.bfloat16)
    leaves = [t.requires_grad_() for p in params.values() for t in p.values()]
    timing = dict(windows=args.windows, calls=args.calls, device=dev)
    for tag, stack in (('baseline_H4', late_stack_baseline),
                       ('fold_h_H1', late_stack_folded)):
        def fwd(v, f=stack):
            with torch.no_grad():
                return f(params, v)

        def fwd_bwd(v, f=stack):
            loss = (f(params, v).float() ** 2).sum()
            return torch.autograd.grad(loss, leaves)
        print(json.dumps({'variant': tag, 'batch': n, 'w': w,
                          'fwd_ms': round(timed_ms(fwd, x, **timing), 3),
                          'fwd_bwd_ms': round(timed_ms(fwd_bwd, x, **timing),
                                              3)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
