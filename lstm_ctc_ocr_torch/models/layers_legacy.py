"""The DSL's legacy vocabulary: the PVANet/FCN-heritage layers.

Counterpart of the JAX package's ``models/layers_legacy.py``, which carries
the reference's inherited layer vocabulary as ``(init, apply)`` pairs; here
each is a module (or a function, where it has no parameters) built by
:func:`build` and run by :func:`apply`, the two halves that
``models/network.py`` calls for a legacy layer. Parameter names and nesting
are the JAX package's, so the weight bridge (``engine/checkpoint.py``) maps
``params/<layer>/conv/kernel`` onto ``<layer>.conv.kernel`` and so on.

Layout: the JAX package defines every layer on NHWC ``[N, A1, A2, C]``; the
port holds 4-D tensors as ``[N, C, A1, A2]`` (``models/layers.py``), so a
layer that concatenates, normalises, softmaxes or scales channels does so
on dim 1, and the reshapes go through NHWC where the JAX one is defined
on it. Each gives the JAX result in the port's layout.

Semantics (the JAX package's, odd places included):

* ``conv`` / ``conv_zero``: a general conv (xavier or zero kernel, zero
  bias, optional relu) — ``layers.ConvSingle`` without batch norm.
* ``conv_norm``: a variance-scaling(0.001) kernel; with bias and relu,
  conv -> bias -> batch norm on the batch's statistics -> relu; with
  ``biased=False, relu=True`` crelu (relu(y) and relu(-y) concatenated,
  doubling the channels); otherwise the bare conv. ``conv_final`` is
  ``conv_norm`` whose input must have 128 channels.
* ``upconv``: ``tf.nn.conv2d_transpose`` to input x stride (or an explicit
  ``shape``); unreachable shapes raise.
* ``batch_normalization`` and the composite blocks' batch norms keep
  frozen moving statistics ``bn_moving_mean`` (zeros) and
  ``bn_moving_var`` (ones): the reference never runs its update ops. Here
  they are buffers, so no optimizer and no weight decay moves them;
  snapshots write them under ``params/`` as the JAX tree holds them.
* ``scale``: per-channel ``alpha * x + beta``.
* ``pva_negation_block``, ``pva_negation_block_v2``,
  ``pva_inception_res_stack`` and ``pva_inception_res_block``: the
  composite PVANet blocks, parameters nested as in the JAX tree.
* :func:`smooth_l1_dist`: a pure function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConvSingle, _cast, channel_dim, channel_view, max_pool,
                     out_dim, variance_scaling_)

BN_EPS = 1e-3


# --- batch norm, scale ---------------------------------------------------------

class BatchNorm(nn.Module):
    """``bn_gamma`` / ``bn_beta`` and the frozen ``bn_moving_mean`` /
    ``bn_moving_var`` buffers (the JAX ``batch_norm_init``)."""

    def __init__(self, c):
        super().__init__()
        self.bn_gamma = nn.Parameter(torch.ones(c))
        self.bn_beta = nn.Parameter(torch.zeros(c))
        self.register_buffer('bn_moving_mean', torch.zeros(c))
        self.register_buffer('bn_moving_var', torch.ones(c))


def batch_norm(bn, x, dtype, is_training=False):
    """The JAX ``batch_norm_apply``: the batch's statistics (biased
    variance, over every axis but the channels) or the frozen ones, in f32;
    the result in ``dtype`` (f32 when None)."""
    x32 = x.float()
    if is_training:
        dims = [d for d in range(x.dim()) if d != channel_dim(x)]
        mean = channel_view(x32.mean(dim=dims), x32)
        var = channel_view(x32.var(dim=dims, unbiased=False), x32)
    else:
        mean = channel_view(bn.bn_moving_mean, x32)
        var = channel_view(bn.bn_moving_var, x32)
    y = (x32 - mean) * torch.rsqrt(var + BN_EPS)
    return _cast(y * channel_view(bn.bn_gamma, x32)
                 + channel_view(bn.bn_beta, x32), dtype)


class Scale(nn.Module):
    """Per-channel ``alpha`` (ones) and ``beta`` (zeros)."""

    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x, dtype=None):
        return _cast(x * channel_view(self.alpha, x)
                     + channel_view(self.beta, x), dtype)


class BnScaleCombo(nn.Module):
    """BN on the frozen statistics, then relu (the reference's Scale step
    is commented out, so there is none); its ``bn`` nested as in JAX."""

    def __init__(self, c):
        super().__init__()
        self.bn = BatchNorm(c)

    def forward(self, x, dtype=None, relu=True):
        y = batch_norm(self.bn, x, dtype)
        return F.relu(y) if relu else y


# --- the conv family -------------------------------------------------------------

def _check_c_i(in_shape, c_i):
    """The input channels of a conv on the JAX-layout ``in_shape``; a
    declared ``c_i`` must match them (the JAX ``conv_init``)."""
    if c_i is None:
        return in_shape[3]
    if in_shape[3] != c_i:
        raise ValueError(
            'conv: declared c_i={} but input has {} channels (the reference '
            'would crash here too, e.g. conv_final hard-codes c_i=128, '
            'network.py:276)'.format(c_i, in_shape[3]))
    return c_i


def _conv_shape(in_shape, k_h, k_w, c_o, s_h, s_w, padding):
    return (in_shape[0], out_dim(in_shape[1], k_h, s_h, padding),
            out_dim(in_shape[2], k_w, s_w, padding), c_o)


def conv(in_shape, k_h, k_w, c_o, s_h, s_w, c_i=None, biased=True,
         relu=False, padding='SAME', kernel_init='xavier', generator=None):
    """A general conv (the JAX ``conv_init`` / ``conv_apply``) on the
    JAX-layout shape ``in_shape``: the module and its output shape."""
    c_i = _check_c_i(in_shape, c_i)
    return (ConvSingle(c_i, c_o, k_h, relu=relu, padding=padding,
                       generator=generator, k2=k_w, stride=(s_h, s_w),
                       biased=biased, kernel_init=kernel_init),
            _conv_shape(in_shape, k_h, k_w, c_o, s_h, s_w, padding))


class ConvNorm(ConvSingle):
    """``conv_norm`` / ``conv_final``: the conv's ``kernel`` (variance
    scaling 0.001) and ``biases``, and on the BN path ``bn_gamma``,
    ``bn_beta`` and the frozen statistics, flat in one layer as in the JAX
    tree. ``mode``: ``'bn'`` (biased and relu), ``'crelu'`` (relu alone)
    or ``'plain'``."""

    def __init__(self, c_i, c_o, k_h, k_w, s_h, s_w, biased=True, relu=True,
                 padding='SAME', generator=None):
        super().__init__(c_i, c_o, k_h, relu=False, padding=padding,
                         generator=generator, k2=k_w, stride=(s_h, s_w),
                         biased=biased, kernel_init=0.001)
        self.mode = 'bn' if biased and relu else 'crelu' if relu else 'plain'
        if self.mode == 'bn':
            self.bn_gamma = nn.Parameter(torch.ones(c_o))
            self.bn_beta = nn.Parameter(torch.zeros(c_o))
            self.register_buffer('bn_moving_mean', torch.zeros(c_o))
            self.register_buffer('bn_moving_var', torch.ones(c_o))

    def forward(self, x, dtype=None):
        y = super().forward(x, dtype)
        if self.mode == 'bn':
            return F.relu(batch_norm(self, y, dtype, is_training=True))
        if self.mode == 'crelu':
            return torch.cat([F.relu(y), F.relu(-y)], dim=1)
        return y


def conv_norm(in_shape, k_h, k_w, c_o, s_h, s_w, c_i=None, biased=True,
              relu=True, padding='SAME', generator=None):
    c_i = _check_c_i(in_shape, c_i)
    out = _conv_shape(in_shape, k_h, k_w, c_o, s_h, s_w, padding)
    if relu and not biased:                    # crelu doubles the channels
        out = out[:3] + (2 * c_o,)
    return ConvNorm(c_i, c_o, k_h, k_w, s_h, s_w, biased, relu, padding,
                    generator), out


def upconv_out_dims(h, w, stride, shape):
    """Output (A1, A2) of ``upconv``: input x stride, or ``shape``'s,
    which a forward SAME conv of this stride must map back onto the
    input (TF rejects other ``output_shape``s too)."""
    if shape is None:
        return h * stride, w * stride
    out_h, out_w = int(shape[1]), int(shape[2])
    for name, i, o in (('height', h, out_h), ('width', w, out_w)):
        if not ((i - 1) * stride < o <= i * stride):
            raise ValueError(
                'upconv: requested output {} {} is unreachable from input '
                '{} with stride {} (tf.nn.conv2d_transpose would reject '
                'this output_shape too)'.format(name, o, i, stride))
    return out_h, out_w


class UpConv(nn.Module):
    """``tf.nn.conv2d_transpose`` (the JAX ``upconv``). ``kernel`` is
    ``[C_in, C_out, k, k]``, ``F.conv_transpose2d``'s layout: the JAX
    kernel is ``[k, k, C_out, C_in]`` (TF's transposed-conv layout), and
    the bridge's HWIO permute ``(3, 2, 0, 1)`` maps it onto exactly this
    one, since both are the input-gradient of a conv from ``C_out`` to
    ``C_in`` channels. The output is the full transposed conv cropped (or
    zero-extended at the end) to the rows TF's SAME padding of the forward
    conv keeps: it starts at that padding's ``before``, ``total // 2``."""

    def __init__(self, c_in, c_o, ksize=4, stride=2, shape=None,
                 biased=False, relu=True, generator=None):
        super().__init__()
        self.ksize, self.stride, self.shape = ksize, stride, shape
        self.relu = relu
        self.kernel = nn.Parameter(torch.empty(c_in, c_o, ksize, ksize))
        variance_scaling_(self.kernel, 0.001, ksize * ksize * c_o,
                          ksize * ksize * c_in, generator)
        self.biases = nn.Parameter(torch.zeros(c_o)) if biased else None

    def forward(self, x, dtype=None):
        x = _cast(x, dtype)
        k, s = self.ksize, self.stride
        outs = upconv_out_dims(x.shape[2], x.shape[3], s, self.shape)
        y = F.conv_transpose2d(x, _cast(self.kernel, dtype), stride=s)
        pads = []
        for i, o in zip(x.shape[2:], outs):
            before = max((i - 1) * s + k - o, 0) // 2
            full = (i - 1) * s + k
            pads.append((-before, o - (full - before)))
        y = F.pad(y, pads[1] + pads[0])
        if self.biases is not None:
            y = y + _cast(self.biases, dtype).view(1, -1, 1, 1)
        return F.relu(y) if self.relu else y


# --- functions without parameters ----------------------------------------------

def lrn(x, radius, alpha, beta, bias=1.0, dtype=None):
    """``tf.nn.local_response_normalization`` over the channels, in f32:
    x / (bias + alpha * window sum of squares) ^ beta."""
    x32 = x.float()
    cd = channel_dim(x)
    sq = torch.square(x32).movedim(cd, -1)
    win = torch.cumsum(F.pad(sq, (radius, radius)), dim=-1)
    win = torch.cat([torch.zeros_like(win[..., :1]), win], dim=-1)
    n_c = x.shape[cd]
    total = win[..., 2 * radius + 1:2 * radius + 1 + n_c] - win[..., :n_c]
    denom = torch.pow(bias + alpha * total.movedim(-1, cd), beta)
    return _cast(x32 / denom, dtype)


def reshape_layer_dims(in_shape, d, name=''):
    """Output shape (JAX layout) of ``reshape_layer``."""
    n, h, w, c = in_shape
    new_h = int(h / d * c) if name == 'rpn_cls_prob_reshape' \
        else int(h * (c / d))
    return n, new_h, w, int(d)


def reshape_layer(x, d, name=''):
    """The FCN/RPN channel-regroup reshape. The JAX one transposes NHWC to
    NCHW, reshapes to ``[N, d, H', W]`` and transposes back; NCHW is the
    port's layout, so it is the reshape alone."""
    n, c, h, w = x.shape
    _, new_h, _, d = reshape_layer_dims((n, h, w, c), d, name)
    return x.reshape(n, d, new_h, w)


def spatial_reshape_layer(x, d):
    """NHWC ``[N, H, W, A*d]`` -> ``[N, H, W*A, d]``."""
    n, h = x.shape[0], x.shape[2]
    y = x.permute(0, 2, 3, 1).reshape(n, h, -1, int(d))
    return y.permute(0, 3, 1, 2)


def smooth_l1_dist(deltas, sigma2=9.0):
    """0.5*sigma2*d^2 where |d| < 1/sigma2, else |d| - 0.5/sigma2."""
    absd = torch.abs(deltas)
    return torch.where(absd < 1.0 / sigma2,
                       torch.square(deltas) * 0.5 * sigma2,
                       absd - 0.5 / sigma2)


# --- PVANet composite blocks -------------------------------------------------------

class PvaNegationBlock(nn.Module):
    """Conv -> BN (frozen) -> [Neg -> Concat] -> [Scale] -> Relu; children
    ``conv``, ``bn``, ``scale``."""

    def __init__(self, in_shape, k_h, k_w, c_o, s_h, s_w, biased=True,
                 padding='SAME', scale=True, negation=True, generator=None):
        super().__init__()
        self.negation = negation
        self.conv, out = conv(in_shape, k_h, k_w, c_o, s_h, s_w,
                              biased=biased, padding=padding,
                              generator=generator)
        self.bn = BatchNorm(c_o)
        c_in = c_o * (2 if negation else 1)
        self.scale = Scale(c_in) if scale else None
        self.out_shape = out[:3] + (c_in,)

    def forward(self, x, dtype=None):
        y = batch_norm(self.bn, self.conv(x, dtype), dtype)
        if self.negation:
            y = torch.cat([y, -y], dim=1)
        if self.scale is not None:
            y = self.scale(y, dtype)
        return F.relu(y)


class PvaNegationBlockV2(nn.Module):
    """BN (frozen) -> [Neg -> Concat -> Scale] -> Relu -> Conv; children
    ``bn``, ``scale``, ``conv``."""

    def __init__(self, in_shape, k_h, k_w, c_o, s_h, s_w, c_in, biased=True,
                 padding='SAME', negation=True, generator=None):
        super().__init__()
        self.negation = negation
        self.bn = BatchNorm(c_in)
        c_mid = c_in * (2 if negation else 1)
        self.scale = Scale(c_mid) if negation else None
        self.conv, self.out_shape = conv(
            tuple(in_shape[:3]) + (c_mid,), k_h, k_w, c_o, s_h, s_w,
            biased=biased, padding=padding, generator=generator)

    def forward(self, x, dtype=None):
        y = batch_norm(self.bn, x, dtype)
        if self.negation:
            y = self.scale(torch.cat([y, -y], dim=1), dtype)
        return self.conv(F.relu(y), dtype)


INCEP_CHANNELS = {'a': (64, 64, 24, 128, 256), 'b': (64, 96, 32, 128, 384)}


class PvaInceptionResStack(nn.Module):
    """Three conv towers (1x1, 3x3, 5x5 as two 3x3) and with
    ``block_start`` a pool tower and a strided projection, concatenated,
    a 1x1 out-projection and the residual add. Children as the JAX tree:
    ``bn``, ``bn_scale``, each tower conv and its ``<conv>_bsc``, ``proj``,
    ``out_conv``, and for ``conv5_4`` ``out_bsc``."""

    def __init__(self, in_shape, c_in, block_start=False, type='a', name='',
                 generator=None):
        super().__init__()
        c_0, c_1, c_2, c_pool, c_out = INCEP_CHANNELS[type]
        self.block_start = block_start
        stride = 2 if block_start else 1
        n, h, w, _ = in_shape
        sh, sw = out_dim(h, 1, stride, 'SAME'), out_dim(w, 1, stride, 'SAME')
        self.bn = BatchNorm(c_in)
        self.bn_scale = Scale(c_in)

        def tower(key, shape, k, c, s):
            m, out = conv(shape, k, k, c, s, s, biased=False,
                          generator=generator)
            self.add_module(key, m)
            self.add_module(key + '_bsc', BnScaleCombo(c))
            return out
        tower('t0_conv', in_shape, 1, c_0, stride)
        # the conv4_1 quirk: its 3x3 tower reduces to 48
        c1_red = 48 if name == 'conv4_1' else c_1
        s = tower('t1_reduce', in_shape, 1, c1_red, stride)
        tower('t1_conv', s, 3, c_1 * 2, 1)
        s = tower('t2_reduce', in_shape, 1, c_2, stride)
        s = tower('t2_conv0', s, 3, c_2 * 2, 1)
        tower('t2_conv1', s, 3, c_2 * 2, 1)
        concat_c = c_0 + c_1 * 2 + c_2 * 2
        if block_start:
            tower('pool_proj', (n, sh, sw, c_in), 1, c_pool, 1)
            concat_c += c_pool
            self.proj, _ = conv(in_shape, 1, 1, c_out, 2, 2, biased=True,
                                generator=generator)
        self.out_conv, _ = conv((n, sh, sw, concat_c), 1, 1, c_out, 1, 1,
                                biased=True, generator=generator)
        self.out_bsc = BnScaleCombo(c_out) if name == 'conv5_4' else None
        self.out_shape = (n, sh, sw, c_out)

    def _tower(self, key, x, dtype):
        return getattr(self, key + '_bsc')(getattr(self, key)(x, dtype),
                                           dtype)

    def forward(self, x, dtype=None):
        bn_scale = self.bn_scale(batch_norm(self.bn, x, dtype), dtype)
        conv_0 = self._tower('t0_conv', bn_scale, dtype)
        y = self._tower('t1_reduce', F.relu(bn_scale), dtype)
        conv_1 = self._tower('t1_conv', y, dtype)
        y = self._tower('t2_reduce', bn_scale, dtype)
        y = self._tower('t2_conv0', y, dtype)
        branches = [conv_0, conv_1, self._tower('t2_conv1', y, dtype)]
        if self.block_start:
            pool = max_pool(bn_scale, 3, 3, 2, 2, 'SAME')
            branches.append(self._tower('pool_proj', pool, dtype))
            proj = self.proj(x, dtype)
        else:
            proj = x
        y = self.out_conv(torch.cat(branches, dim=1), dtype)
        if self.out_bsc is not None:
            y = self.out_bsc(y, dtype, relu=False)
        return y + proj


def _block_c_ins(type):
    return (128, 256, 256, 256) if type == 'a' else (256, 384, 384, 384)


class PvaInceptionResBlock(nn.Module):
    """Four chained res stacks ``stack1``..``stack4``, the first with
    ``block_start``."""

    def __init__(self, in_shape, name_prefix='conv4_', type='a',
                 generator=None):
        super().__init__()
        shape = in_shape
        for i, c_in in enumerate(_block_c_ins(type), 1):
            stack = PvaInceptionResStack(shape, c_in, block_start=(i == 1),
                                         type=type, name=name_prefix + str(i),
                                         generator=generator)
            self.add_module('stack{}'.format(i), stack)
            shape = stack.out_shape
        self.out_shape = shape

    def forward(self, x, dtype=None):
        for i in range(1, 5):
            x = getattr(self, 'stack{}'.format(i))(x, dtype)
        return x


# --- the DSL's two halves --------------------------------------------------------

def build(kind, kw, in_shapes, generator=None):
    """``(module or None, JAX-layout output shape)`` of a legacy layer (the
    JAX ``Network._init_legacy_layer``)."""
    s = in_shapes[0]
    g = generator
    if kind in ('conv', 'conv_zero'):
        return conv(s, kw['k_h'], kw['k_w'], kw['c_o'], kw['s_h'], kw['s_w'],
                    kw.get('c_i'), kw['biased'], kw['relu'], kw['padding'],
                    'xavier' if kind == 'conv' else 'zero', g)
    if kind in ('conv_norm', 'conv_final'):
        return conv_norm(s, kw['k_h'], kw['k_w'], kw['c_o'], kw['s_h'],
                         kw['s_w'], 128 if kind == 'conv_final' else None,
                         kw['biased'], kw['relu'], kw['padding'], g)
    if kind == 'upconv':
        out_h, out_w = upconv_out_dims(s[1], s[2], kw['stride'], kw['shape'])
        return (UpConv(s[3], kw['c_o'], kw['ksize'], kw['stride'],
                       kw['shape'], kw['biased'], kw['relu'], g),
                (s[0], out_h, out_w, kw['c_o']))
    if kind in ('relu', 'lrn', 'spatial_softmax', 'negation', 'add'):
        return None, s
    if kind == 'reshape_layer':
        return None, reshape_layer_dims(s, kw['d'], kw['name'])
    if kind == 'spatial_reshape_layer':
        n, h, w, c = s
        return None, (n, h, w * c // int(kw['d']), int(kw['d']))
    if kind == 'scale':
        return Scale(kw['c_in']), s
    if kind == 'batch_normalization':
        return BatchNorm(s[-1]), s
    if kind == 'bn_scale_combo':
        return BnScaleCombo(kw['c_in']), s
    if kind == 'pva_negation_block':
        m = PvaNegationBlock(s, kw['k_h'], kw['k_w'], kw['c_o'], kw['s_h'],
                             kw['s_w'], kw['biased'], kw['padding'],
                             kw['scale'], kw['negation'], g)
        return m, m.out_shape
    if kind == 'pva_negation_block_v2':
        m = PvaNegationBlockV2(s, kw['k_h'], kw['k_w'], kw['c_o'], kw['s_h'],
                               kw['s_w'], kw['c_in'], kw['biased'],
                               kw['padding'], kw['negation'], g)
        return m, m.out_shape
    if kind == 'pva_inception_res_stack':
        m = PvaInceptionResStack(s, kw['c_in'], kw['block_start'],
                                 kw['type'], kw['name'], g)
        return m, m.out_shape
    if kind == 'pva_inception_res_block':
        m = PvaInceptionResBlock(s, kw['name_prefix'], kw['type'], g)
        return m, m.out_shape
    raise ValueError('unknown layer kind: ' + kind)


def apply(kind, module, xs, kw, dtype=None):
    """A legacy layer's output on its inputs ``xs`` (port layout)."""
    x = xs[0]
    if kind == 'relu':
        return F.relu(x)
    if kind == 'lrn':
        return lrn(x, kw['radius'], kw['alpha'], kw['beta'], kw['bias'],
                   dtype)
    if kind == 'reshape_layer':
        return reshape_layer(x, kw['d'], kw['name'])
    if kind == 'spatial_reshape_layer':
        return spatial_reshape_layer(x, kw['d'])
    if kind == 'spatial_softmax':
        return torch.softmax(x, dim=channel_dim(x))
    if kind == 'add':
        return xs[0] + xs[1]
    if kind == 'negation':
        return x * -1.0
    if kind == 'batch_normalization':
        y = batch_norm(module, x, dtype, kw['is_training'])
        return F.relu(y) if kw['relu'] else y
    if kind == 'bn_scale_combo':
        return module(x, dtype, kw['relu'])
    if module is None:
        raise ValueError('unknown layer kind: ' + kind)
    return module(x, dtype)
