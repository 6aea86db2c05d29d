"""The CRNN of the benchmark's configurations in plain PyTorch: a forward
pass over a dictionary of tensors, written from the model's description
and independent of the program.

    data [N, W, 32] (uint8 pixels / 255, or f32); the width axis is time
    conv1 3x3x64  -> pool 2x2      conv2 3x3x128 -> pool 2x2
    conv3_1, conv3_2 3x3x256       -> pool 1x2 (height only)
    conv4_1, conv4_2 3x3x512, batch norm (eps 1e-3, biased variance,
        statistics over N, W and H, padded columns included) -> pool 1x2
    conv5 2x2x512 VALID, no relu   -> features [N, T = W/4 - 1, 512]
    BiLSTM 2 x num_hid/2, TF1 gate order (i, j, f, o), forget bias 1.0,
        length-masked (outputs past a row's length are zero, its state
        stops; the backward direction runs over the length-reversed row)
    projection in f32 -> time-major logits [T, N, nclasses]

Layout: images are ``[N, C, W, H]`` and kernels ``[C_out, C_in, kW, kH]``;
a SAME 3x3 conv at stride 1 pads 1 on each side.

``prec`` emulates a lower precision at the points where the configuration
computes in its compute type (conv and matmul inputs, weights and outputs,
the conv bias and the batch norm's output): ``None`` is f32 throughout,
``'fp8'`` rounds to float8 e4m3 with a per-tensor scale, forward and
backward.
That is the control: the reference in the nearest precision below the
configuration's bfloat16. The CTC and the projection stay f32, as the
configuration keeps them.

The dictionary's keys are ``<layer>.<leaf>``: ``conv*.kernel``,
``conv*.biases``, ``conv4_*.bn_gamma`` / ``bn_beta`` and the moving
statistics ``bn_mean`` / ``bn_var``, ``logits.cells.{fw,bw}.{w,u,bias}``
(``w`` [512, 4H], ``u`` [H, 4H]) and ``logits.weights`` / ``biases``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
FP8_MAX = 448.0

# (name, c_in, c_out, k, batch norm, relu); c_in None: the image channels
CONVS = (('conv1', None, 64, 3, False, True),
         ('conv2', 64, 128, 3, False, True),
         ('conv3_1', 128, 256, 3, False, True),
         ('conv3_2', 256, 256, 3, False, True),
         ('conv4_1', 256, 512, 3, True, True),
         ('conv4_2', 512, 512, 3, True, True),
         ('conv5', 512, 512, 2, False, False))


class _RoundFP8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale on the way in and on
    the way back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _fp8(x):
    """``x`` through float8 e4m3 as fp8 compute casts it: scaled so that
    its largest magnitude maps to the format's largest, 448, rounded, and
    scaled back (without the scale small gradients would flush to 0)."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn) \
        .to(x.dtype) / scale


def quantizer(prec):
    """The rounding applied at the compute-type points."""
    if prec is None:
        return lambda x: x
    if prec == 'fp8':
        return _RoundFP8.apply
    raise ValueError('prec: None or fp8, not {!r}'.format(prec))


def param_shapes(nchannels=1, num_hid=512, nclasses=64):
    """``{key: shape}`` of every parameter and moving statistic."""
    shapes = {}
    for name, c_in, c_out, k, bn, _ in CONVS:
        shapes[name + '.kernel'] = (c_out, c_in or nchannels, k, k)
        shapes[name + '.biases'] = (c_out,)
        if bn:
            for leaf in ('bn_gamma', 'bn_beta', 'bn_mean', 'bn_var'):
                shapes['{}.{}'.format(name, leaf)] = (c_out,)
    h = num_hid // 2
    for d in ('fw', 'bw'):
        shapes['logits.cells.{}.w'.format(d)] = (512, 4 * h)
        shapes['logits.cells.{}.u'.format(d)] = (h, 4 * h)
        shapes['logits.cells.{}.bias'.format(d)] = (4 * h,)
    shapes['logits.weights'] = (num_hid, nclasses)
    shapes['logits.biases'] = (nclasses,)
    return shapes


def is_buffer(key):
    """The moving BN statistics: state, not parameters."""
    return key.endswith('.bn_mean') or key.endswith('.bn_var')


def make_params(seed, device, nchannels=1, num_hid=512, nclasses=64):
    """Weights drawn from ``seed`` on ``device`` in one call of a
    generator on that device: every kernel and LSTM weight uniform in the
    Glorot bound of its fan-in and fan-out (an LSTM cell's ``w`` and ``u``
    share the bound of its stacked ``[D + H, 4H]`` kernel), the projection
    at a tenth of it; biases and BN shifts zero, BN scales and moving
    variances one, moving means zero."""
    shapes = param_shapes(nchannels, num_hid, nclasses)
    h = num_hid // 2

    def bound(key, shape):
        if key.endswith('.kernel'):
            c_out, c_in, k, k2 = shape
            return math.sqrt(6.0 / (c_in * k * k2 + c_out * k * k2))
        if key.endswith('.w') or key.endswith('.u'):
            return math.sqrt(6.0 / (512 + h + 4 * h))
        if key == 'logits.weights':
            return 0.1 * math.sqrt(6.0 / (shape[0] + shape[1]))
        return None

    drawn = [(k, s, bound(k, s)) for k, s in shapes.items()]
    total = sum(math.prod(s) for k, s, b in drawn if b is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    params, off = {}, 0
    for key, shape, b in drawn:
        if b is not None:
            n = math.prod(shape)
            params[key] = (flat[off:off + n] * b).view(shape).clone()
            off += n
        elif key.endswith('bn_gamma') or key.endswith('bn_var'):
            params[key] = torch.ones(shape, device=device)
        else:
            params[key] = torch.zeros(shape, device=device)
    return params


def _conv(p, name, x, k, bn, relu, q, moving_bn, bn_collect):
    pad = 0 if k == 2 else (k - 1) // 2
    y = F.conv2d(q(x), q(p[name + '.kernel']), padding=pad)
    y = q(y)
    y = q(y + q(p[name + '.biases']).view(1, -1, 1, 1))
    if bn:
        if moving_bn:
            mean = p[name + '.bn_mean'].view(1, -1, 1, 1)
            var = p[name + '.bn_var'].view(1, -1, 1, 1)
        else:
            mean = y.mean(dim=(0, 2, 3), keepdim=True)
            var = y.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
            if bn_collect is not None:
                bn_collect[name] = (mean.detach().reshape(-1),
                                    var.detach().reshape(-1))
        y = (y - mean) * torch.rsqrt(var + BN_EPS)
        y = q(y * p[name + '.bn_gamma'].view(1, -1, 1, 1)
              + p[name + '.bn_beta'].view(1, -1, 1, 1))
    return F.relu(y) if relu else y


def _reverse(x_tm, lens):
    """Reverse each row's first ``lens[n]`` frames of [T, N, ...]; frames
    past a row's length stay where they are."""
    t_len, n = x_tm.shape[:2]
    t = torch.arange(t_len, device=x_tm.device)[:, None].expand(t_len, n)
    lens = lens.to(torch.int64)[None, :]
    src = torch.where(t < lens, lens - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (x_tm.dim() - 2)).expand(x_tm.shape)
    return torch.gather(x_tm, 0, src)


def _scan(xp, u, bias, lens, q):
    """One direction's masked LSTM over the input projection ``xp``
    [T, N, 4H]: [T, N, H], zero past each row's length."""
    t_len, n, four_h = xp.shape
    h = xp.new_zeros(n, four_h // 4)
    c = torch.zeros_like(h)
    u = q(u)
    outs = []
    for t in range(t_len):
        gates = xp[t] + q(q(h) @ u) + bias
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        live = (t < lens)[:, None].to(h.dtype)
        h = live * new_h + (1.0 - live) * h
        c = live * new_c + (1.0 - live) * c
        outs.append(live * new_h)
    return torch.stack(outs)


def forward(p, data, lens, prec=None, moving_bn=False, bn_collect=None):
    """``data`` [N, W, H] (uint8 or f32), ``lens`` [N] int32 -> f32
    logits [T, N, C]. ``bn_collect`` (a dict) receives each BN layer's
    batch ``(mean, var)``."""
    q = quantizer(prec)
    if data.dtype == torch.uint8:
        data = data.float() / 255.0
    x = data.float().unsqueeze(1)
    for name, _, _, k, bn, relu in CONVS:
        x = _conv(p, name, x, k, bn, relu, q, moving_bn, bn_collect)
        if name in ('conv1', 'conv2'):
            x = F.max_pool2d(x, (2, 2), (2, 2))
        elif name in ('conv3_2', 'conv4_2'):
            x = F.max_pool2d(x, (1, 2), (1, 2))
    n = x.shape[0]
    feats = x.permute(0, 2, 3, 1).reshape(n, -1, 512)       # [N, T, 512]
    x_tm = q(feats).transpose(0, 1)
    t_len = x_tm.shape[0]
    lens = lens.to(x_tm.device)
    outs = []
    for d in ('fw', 'bw'):
        w = q(p['logits.cells.{}.w'.format(d)])
        xin = x_tm if d == 'fw' else _reverse(x_tm, lens)
        xp = q(xin.reshape(t_len * n, 512) @ w).reshape(t_len, n, -1)
        out = _scan(xp, p['logits.cells.{}.u'.format(d)],
                    q(p['logits.cells.{}.bias'.format(d)]), lens, q)
        outs.append(q(out) if d == 'fw' else q(_reverse(out, lens)))
    out = torch.cat(outs, dim=-1)                            # [T, N, 2H]
    return out @ p['logits.weights'] + p['logits.biases']


def l2_loss(p, weight_decay):
    """``weight_decay * sum(w^2) / 2`` over the conv kernels and the
    projection weights."""
    keys = [name + '.kernel' for name, *_ in CONVS] + ['logits.weights']
    return sum(weight_decay * 0.5 * torch.sum(torch.square(p[k]))
               for k in keys)
