"""Puigcerver's handwriting recogniser (ICDAR 2017; PyLaia's ``egs/iam``)
in plain PyTorch: the forward pass over a dictionary of tensors, its
dropout masks, the CTC loss with its L2 term, and the training step, all
written from the model's description and independent of the program.

    data [N, W, H] (uint8 pixels / 255, or f32); the width axis is time
    5 blocks: [dropout 0.2 on blocks 3-5's input] conv 3x3 SAME, no bias
        (16, 32, 48, 64, 80 filters) -> batch norm (eps 1e-3, biased
        variance, statistics over N, W and H, padded columns included)
        -> LeakyReLU 0.01 [-> max pool 2x2 on blocks 1-3]
    features [N, T = W // 8, (H / 8) * 80], ordered (height, channel)
    num_layers x [dropout 0.5 ->] BiLSTM 2 x num_hid/2, gate order
        (i, j, f, o), one bias, forget bias 0, length-masked (outputs past a
        row's length are zero, its state stops; the backward direction runs
        over the length-reversed row)
    dropout 0.5 -> projection in f32 -> time-major logits [T, N, nclasses]

Layout: images ``[N, C, W, H]``, kernels ``[C_out, C_in, 3, 3]``, padding
1 each side. Sequences are time-major ``[T, N, D]``.

Dropout (training only) is inverted: an element is kept with probability
``keep`` and scaled by ``1 / keep``. Its mask is a counter-based hash:
layer ``i``'s key at step ``s`` under seed ``seed`` is
``mix(s ^ mix(mix(seed) ^ i))`` and element ``j`` (its flat index in the
layouts above) is kept where ``mix(mix(j) ^ key) < round(keep * 2^32)``,
``mix`` the 32-bit xor-shift-multiply of :func:`_mix32`. The layers are
numbered in order: conv3's, conv4's and conv5's inputs, each BiLSTM's
input, the projection's input.

``prec`` is ``reference/model.py``'s: ``None`` is f32 throughout, ``'fp8'``
rounds to float8 e4m3 with a per-tensor scale at the points where the
configuration computes in bfloat16 (conv and matmul inputs, weights and
outputs, batch norm's and the activation's outputs, the dropped
values, the recurrence's outputs). The CTC and the projection stay f32.

Keys: ``conv<k>.kernel``, ``conv<k>.bn_gamma`` / ``bn_beta`` and the
moving statistics ``bn_mean`` / ``bn_var``;
``logits.layers.<i>.cells.{fw,bw}.{w,u,bias}`` (``w`` [D, 4H], ``u``
[H, 4H]); ``logits.weights`` [num_hid, nclasses], ``logits.biases``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import ctc
from .model import quantizer

BN_EPS = 1e-3
LEAKY = 0.01
CONVS = (('conv1', 16), ('conv2', 32), ('conv3', 48), ('conv4', 64),
         ('conv5', 80))
POOLED = ('conv1', 'conv2', 'conv3')
CONV_DROP = ('conv3', 'conv4', 'conv5')
CONV_KEEP, LSTM_KEEP = 0.8, 0.5
M32 = 0xFFFFFFFF


def _mix32(x):
    """The 32-bit xor-shift-multiply hash, on int64 tensors (or ints)
    holding values below 2^32."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 16)


def dropout_key(seed, layer, step):
    """The key of dropout layer ``layer`` at step ``step`` (ints)."""
    return _mix32((int(step) & M32) ^ _mix32(_mix32(int(seed) & M32)
                                             ^ int(layer)))


def dropout_mask(shape, keep, key, device):
    """Bool mask of ``shape``: element ``j`` (flat index) kept where its
    hash under ``key`` falls below ``round(keep * 2^32)``."""
    j = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (_mix32(_mix32(j) ^ int(key))
            < int(round(keep * 2.0 ** 32))).view(shape)


def features(height):
    """Features a frame: ``(height // 8) * 80``."""
    return (int(height) // 8) * CONVS[-1][1]


def param_shapes(nchannels=1, num_hid=512, num_layers=5, nclasses=80,
                 height=128):
    """``{key: shape}`` of every parameter and moving statistic."""
    shapes = {}
    c_in = nchannels
    for name, c_out in CONVS:
        shapes[name + '.kernel'] = (c_out, c_in, 3, 3)
        for leaf in ('bn_gamma', 'bn_beta', 'bn_mean', 'bn_var'):
            shapes['{}.{}'.format(name, leaf)] = (c_out,)
        c_in = c_out
    h = num_hid // 2
    for i in range(num_layers):
        d = features(height) if i == 0 else num_hid
        for di in ('fw', 'bw'):
            base = 'logits.layers.{}.cells.{}.'.format(i, di)
            shapes[base + 'w'] = (d, 4 * h)
            shapes[base + 'u'] = (h, 4 * h)
            shapes[base + 'bias'] = (4 * h,)
    shapes['logits.weights'] = (num_hid, nclasses)
    shapes['logits.biases'] = (nclasses,)
    return shapes


def is_buffer(key):
    """The moving BN statistics: state, not parameters."""
    return key.endswith('.bn_mean') or key.endswith('.bn_var')


def make_params(seed, device, nchannels=1, num_hid=512, num_layers=5,
                nclasses=80, height=128):
    """Weights drawn from ``seed`` on ``device`` in one call of a generator
    on that device: conv kernels and LSTM weights uniform in the Glorot
    bound of their fan-in and fan-out (a cell's ``w`` and ``u`` share the
    bound of its stacked ``[D + H, 4H]`` kernel), the projection at a tenth
    of it; BN shifts and LSTM biases zero, BN scales and moving variances
    one, moving means zero."""
    shapes = param_shapes(nchannels, num_hid, num_layers, nclasses, height)
    h = num_hid // 2

    def bound(key, shape):
        if key.endswith('.kernel'):
            c_out, c_in, k, k2 = shape
            return math.sqrt(6.0 / (c_in * k * k2 + c_out * k * k2))
        if key.endswith('.w') or key.endswith('.u'):
            d = shapes[key.rsplit('.', 1)[0] + '.w'][0]
            return math.sqrt(6.0 / (d + h + 4 * h))
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


def _drop(x, keep, key, q):
    mask = dropout_mask(tuple(x.shape), keep, key, x.device)
    return q(torch.where(mask, x / keep, torch.zeros_like(x)))


def _block(p, name, x, q, moving_bn, bn_collect):
    y = q(F.conv2d(q(x), q(p[name + '.kernel']), padding=1))
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
    return q(F.leaky_relu(y, LEAKY))


def _reverse(x_tm, lens):
    """Reverse each row's first ``lens[n]`` frames of [T, N, ...]."""
    t_len, n = x_tm.shape[:2]
    t = torch.arange(t_len, device=x_tm.device)[:, None].expand(t_len, n)
    lens = lens.to(torch.int64)[None, :]
    src = torch.where(t < lens, lens - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (x_tm.dim() - 2)).expand(x_tm.shape)
    return torch.gather(x_tm, 0, src)


def bilstm_layer(p, i, x_tm, lens, q):
    """Layer ``i``: both directions scanned frame by frame together (the
    backward over the length-reversed rows) -> [T, N, 2H]."""
    t_len, n, d = x_tm.shape
    base = 'logits.layers.{}.cells.'.format(i)
    xs = torch.stack([x_tm, _reverse(x_tm, lens)])            # [2, T, N, D]
    w = torch.stack([q(p[base + 'fw.w']), q(p[base + 'bw.w'])])
    xp = q(torch.bmm(xs.reshape(2, t_len * n, d), w)).reshape(
        2, t_len, n, -1)
    u = torch.stack([q(p[base + 'fw.u']), q(p[base + 'bw.u'])])
    bias = torch.stack([q(p[base + 'fw.bias']), q(p[base + 'bw.bias'])])
    h = xp.new_zeros(2, n, u.shape[1])
    c = torch.zeros_like(h)
    outs = []
    for t in range(t_len):
        gates = xp[:, t] + q(torch.bmm(q(h), u)) + bias[:, None, :]
        gi, gj, gf, go = torch.chunk(gates, 4, dim=-1)
        new_c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gj)
        new_h = torch.sigmoid(go) * torch.tanh(new_c)
        live = (t < lens)[None, :, None].to(h.dtype)
        h = live * new_h + (1.0 - live) * h
        c = live * new_c + (1.0 - live) * c
        outs.append(live * new_h)
    out = q(torch.stack(outs, dim=1))                         # [2, T, N, H]
    return torch.cat([out[0], _reverse(out[1], lens)], dim=-1)


def forward(p, data, lens, prec=None, moving_bn=False, bn_collect=None,
            step=None, seed=3):
    """``data`` [N, W, H] (uint8 or f32), ``lens`` [N] int32 -> f32 logits
    [T, N, C]. ``step`` (an int) turns dropout on, its masks keyed by
    ``seed``, the layer and ``step``; None is the eval graph.
    ``bn_collect`` (a dict) receives each block's batch ``(mean, var)``."""
    q = quantizer(prec)
    if data.dtype == torch.uint8:
        data = data.float() / 255.0
    x = data.float().unsqueeze(1)
    num_layers = len({k.split('.')[2] for k in p
                      if k.startswith('logits.layers.')})
    keys = None if step is None else \
        [dropout_key(seed, i, step)
         for i in range(len(CONV_DROP) + num_layers + 1)]
    for name, _ in CONVS:
        if keys is not None and name in CONV_DROP:
            x = _drop(x, CONV_KEEP, keys[CONV_DROP.index(name)], q)
        x = _block(p, name, x, q, moving_bn, bn_collect)
        if name in POOLED:
            x = F.max_pool2d(x, (2, 2), (2, 2))
    n = x.shape[0]
    feats = x.permute(0, 2, 3, 1).reshape(n, x.shape[2], -1)  # [N, T, F]
    x_tm = q(feats).transpose(0, 1)
    lens = lens.to(x_tm.device)
    for i in range(num_layers):
        if keys is not None:
            x_tm = _drop(x_tm, LSTM_KEEP, keys[len(CONV_DROP) + i], q)
        x_tm = bilstm_layer(p, i, q(x_tm), lens, q)
    if keys is not None:
        x_tm = _drop(x_tm, LSTM_KEEP, keys[-1], q)
    return x_tm @ p['logits.weights'] + p['logits.biases']


def l2_loss(p, weight_decay):
    """``weight_decay * sum(w^2) / 2`` over the conv kernels and the
    projection weights."""
    keys = [name + '.kernel' for name, _ in CONVS] + ['logits.weights']
    return sum(weight_decay * 0.5 * torch.sum(torch.square(p[k]))
               for k in keys)


def train_steps(state, batches, hp, seed, prec=None, fault=None,
                moments=None, count0=0):
    """``reference/train.py:train_steps`` for this model: the mean CTC loss
    over the feasible examples plus the L2 term, the gradient by autograd,
    the global-norm clip (scaling only at ``norm >= clip``, no epsilon),
    Adam with the step-decay learning rate and bias corrections at the
    update count from 1, then the moving BN statistics. The step after
    ``count`` updates draws its dropout masks at step ``count + 1`` under
    ``seed``. ``fault``: ``'frozen'`` leaves the state unchanged,
    ``'half'`` takes the mean over the first half of the batch only.
    Returns ``(losses, (mu, nu), state)``."""
    p = {k: v.detach().clone() for k, v in state.items()}
    names = [k for k in p if not is_buffer(k)]
    if moments is None:
        mu = {k: torch.zeros_like(p[k]) for k in names}
        nu = {k: torch.zeros_like(p[k]) for k in names}
    else:
        mu, nu = ({k: v[k].detach().clone() for k in names} for v in moments)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for count, (image, label, label_len, t_step) in enumerate(batches,
                                                              count0):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        params = dict(p, **leaves)
        bn_batch = {}
        logits = forward(params, image, t_step, prec=prec,
                         bn_collect=bn_batch, step=count + 1, seed=seed)
        per = ctc.ctc_loss(logits.transpose(0, 1), label.long(), label_len,
                           t_step)
        feasible = per < 1e29
        if fault == 'half':
            feasible = feasible & (torch.arange(per.shape[0],
                                                device=per.device)
                                   < per.shape[0] // 2)
        mean = torch.where(feasible, per, torch.zeros_like(per)).sum() \
            / torch.clamp(feasible.sum(), min=1)
        total = mean + l2_loss(params, hp['weight_decay'])
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            for k in names:
                p[k] = p[k].detach()
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < hp['clip'], torch.ones_like(norm),
                                hp['clip'] / norm)
            grads = [g * scale for g in grads]
            lr = hp['lr'] * hp['gamma'] ** (count // hp['stepsize'])
            t = count + 1
            for k, g in zip(names, grads):
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                if fault == 'frozen':
                    continue
                upd = (mu[k] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                p[k] = p[k] - lr * upd
            m = hp['bn_momentum']
            for name, (bm, bv) in bn_batch.items():
                if fault == 'frozen':
                    continue
                p[name + '.bn_mean'] = m * p[name + '.bn_mean'] + (1 - m) * bm
                p[name + '.bn_var'] = m * p[name + '.bn_var'] + (1 - m) * bv
    return losses, (mu, nu), {k: v.detach() for k, v in p.items()}
