"""The CRNN's layers as ``nn.Module``s with the JAX package's parameter names.

Counterpart of the JAX package's ``models/layers.py``: ``conv_single``
(bias, batch norm, relu, any kernel, stride and TF padding), ``max_pool``
and ``avg_pool``, ``reshape_squeeze``, ``bi_lstm`` with its f32
projection, the stacked unidirectional ``lstm`` variant, the stacked
BiLSTM head of the handwriting model (``models/htr.py``), and the layers
only the model DSL uses (``models/network.py``): ``fc``, ``softmax`` and
``dropout``.

Conv lowering (``CONV_IMPL``, the JAX ``conv_single_apply``): ``'xla'``
(the default) is ``F.conv2d`` (cuDNN on the card); ``'shifted'`` takes
``ops/conv.py:conv2d_shifted``, the tap sum as one GEMM, for every
``ConvSingle`` whose contraction ``k * k2 * c_i`` is at least 256 — in the
CRNN all but conv1. Another value raises ``ValueError`` by name. The
legacy layers (``models/layers_legacy.py``) keep ``F.conv2d``, as the JAX
legacy layers keep XLA's conv.

Layout: the JAX package runs images as ``[N, W, H, C]`` with HWIO kernels
whose *first* spatial axis runs over image width. The port runs
``[N, C, W, H]`` — the same two spatial axes in the same order — with
kernels ``[C_out, C_in, kW, kH]`` (``hwio.permute(3, 2, 0, 1)``), so a SAME
3x3 conv is ``padding=1``, the VALID 2x2 conv5 is ``padding=0`` and a
``(1, 2)`` pool pools the height only.

TF's ``SAME`` padding puts the odd extra row or column at the end of an
axis; ``F.conv2d(padding=int)`` pads both ends alike, so a geometry whose
two ends differ (an even kernel, or a stride) pads explicitly first
(:func:`same_pads`), with -inf for a max pool and zeros otherwise. The
main path's geometry (odd kernels at stride 1, the VALID conv5, pools
with stride = window) keeps its plain calls.

Cast points follow ``layers.py:66-107,154-160``: the conv and ``+bias`` run
in the compute dtype, batch norm runs in f32 on the compute-dtype output
and casts back before relu, pools run in the compute dtype, and the
BiLSTM's and the stacked LSTM's projection runs in f32 on its
(compute-dtype) outputs.

Under data parallelism (``parallel/mesh.py``) the batch statistics are the
global batch's, as XLA all-reduces ``jnp.mean`` / ``jnp.var`` over a
sharded batch (``layers.py:98-99``): ``batch_moments`` with a process group
sums each channel and the element count over the ranks, then the squared
deviations from that global mean, both through the differentiable
all-reduce, so the gradient flows through the global mean and variance.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import rnn
from ..ops.conv import (CONV_IMPLS, MIN_CONTRACTION, conv2d_shifted,
                        pad_amount)
from ..utils.profiler import count, span

BN_EPS = 1e-3


def _glorot_(t, fan_in, fan_out, generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def variance_scaling_(t, factor, fan_in, fan_out, generator):
    """``variance_scaling(factor, 'fan_avg', 'truncated_normal')``: a
    normal truncated at two standard deviations, rescaled so that the
    truncated draw has variance ``factor / ((fan_in + fan_out) / 2)``."""
    std = math.sqrt(factor / ((fan_in + fan_out) / 2.0)) / 0.87962566
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def out_dim(size, k, s, padding):
    """Output length of one axis under TF's ``SAME`` or ``VALID``."""
    if padding == 'SAME':
        return -(-size // s)
    return -(-(size - k + 1) // s)


def same_pads(size, k, s):
    """TF ``SAME`` padding of one axis: (before, after), the odd one after."""
    return pad_amount(size, k, s, 'SAME')[:2]


def _tf_pads(x, k, s, padding):
    """``F.pad`` order (last axis first) of TF padding over dims 2 and 3 of
    ``x``, or None where there is none."""
    if padding != 'SAME':
        return None
    (a0, a1), (b0, b1) = (same_pads(x.shape[2 + i], k[i], s[i])
                          for i in range(2))
    return (b0, b1, a0, a1) if a0 or a1 or b0 or b1 else None


def conv2d_tf(x, kernel, stride=(1, 1), padding='SAME'):
    """``F.conv2d`` of ``x`` [N, C, A1, A2] with TF ``SAME`` / ``VALID``
    padding (the JAX ``conv_general_dilated``)."""
    pads = _tf_pads(x, kernel.shape[2:], stride, padding)
    if pads is None:
        return F.conv2d(x, kernel, stride=stride)
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return F.conv2d(x, kernel, stride=stride, padding=(pads[2], pads[0]))
    return F.conv2d(F.pad(x, pads), kernel, stride=stride)


def _cast(x, dtype):
    return x if dtype is None else x.to(dtype)


def batch_moments(y32, group=None):
    """Per-channel mean and biased variance ``[1, C, 1, 1]`` of ``y32``
    ``[N, C, W, H]`` (f32) over (N, W, H). With a process ``group``: over
    every rank's rows (their W may differ), by two all-reduces whose
    backward all-reduces the gradient, so each rank's input receives the
    gradient the global statistics pass back from every rank's rows."""
    if group is None:
        return (y32.mean(dim=(0, 2, 3), keepdim=True),
                y32.var(dim=(0, 2, 3), unbiased=False, keepdim=True))
    from ..parallel.mesh import all_reduce_sum as all_reduce
    c = y32.shape[1]
    count = y32.new_full((1,), y32.numel() // c)
    sums = all_reduce(torch.cat([y32.sum(dim=(0, 2, 3)), count]),
                      group=group)
    n = sums[c]
    mean = (sums[:c] / n).view(1, -1, 1, 1)
    sq = all_reduce(torch.square(y32 - mean).sum(dim=(0, 2, 3)), group=group)
    return mean, (sq / n).view(1, -1, 1, 1)


class ConvSingle(nn.Module):
    """Conv (+ bias) (+ training-mode batch norm) (+ relu).

    Parameters ``kernel`` [C_out, C_in, k, k2] (``k2`` defaults to ``k``),
    ``biases`` unless ``biased`` is false, and with ``bn`` also
    ``bn_gamma``/``bn_beta`` and the moving-statistics buffers ``bn_mean``
    (zeros) / ``bn_var`` (ones) — the JAX ``init_bn_state``. ``stride`` is
    (s, s2); ``padding`` TF's ``SAME`` or ``VALID``. ``kernel_init``:
    ``'xavier'`` (glorot uniform), ``'zero'``, or a float, the factor of a
    fan-average truncated-normal variance scaling (the legacy convs).
    ``conv_impl``: ``'xla'`` or ``'shifted'`` (``CONV_IMPL``); ``shifted``
    is ``True`` where the layer takes the shifted-matmul lowering.
    """

    def __init__(self, c_i, c_o, k, bn=False, relu=True, padding='SAME',
                 generator=None, k2=None, stride=(1, 1), biased=True,
                 kernel_init='xavier', conv_impl='xla'):
        super().__init__()
        k2 = k if k2 is None else k2
        if conv_impl not in CONV_IMPLS:
            raise ValueError('CONV_IMPL={!r}: expected one of {}'.format(
                conv_impl, CONV_IMPLS))
        self.shifted = conv_impl == 'shifted' \
            and k * k2 * c_i >= MIN_CONTRACTION
        self.bn, self.relu = bn, relu
        self.stride, self.pad_mode = tuple(stride), padding
        # the main path's geometry keeps its symmetric int padding
        self.padding = None
        if self.stride == (1, 1) and padding == 'VALID':
            self.padding = 0
        elif self.stride == (1, 1) and k % 2 and k2 % 2:
            self.padding = (k - 1) // 2 if k == k2 else \
                ((k - 1) // 2, (k2 - 1) // 2)
        self.kernel = nn.Parameter(torch.empty(c_o, c_i, k, k2))
        if kernel_init == 'xavier':
            _glorot_(self.kernel, c_i * k * k2, c_o * k * k2, generator)
        elif kernel_init == 'zero':
            with torch.no_grad():
                self.kernel.zero_()
        else:
            variance_scaling_(self.kernel, float(kernel_init),
                              c_i * k * k2, c_o * k * k2, generator)
        self.biases = nn.Parameter(torch.zeros(c_o)) if biased else None
        if bn:
            self.bn_gamma = nn.Parameter(torch.ones(c_o))
            self.bn_beta = nn.Parameter(torch.zeros(c_o))
            self.register_buffer('bn_mean', torch.zeros(c_o))
            self.register_buffer('bn_var', torch.ones(c_o))

    def forward(self, x, dtype=None, moving_bn=False, bn_collect=None,
                bn_group=None):
        """``bn_collect``: a list the caller owns; a ``bn`` layer running on
        batch statistics appends ``(layer, mean [C], biased var [C])`` to
        it, for the train step's moving-statistics update. ``bn_group``: a
        process group whose ranks' rows share the batch statistics."""
        x = _cast(x, dtype)
        if self.shifted:
            y = conv2d_shifted(x, _cast(self.kernel, dtype), self.stride,
                               self.pad_mode)
        elif self.padding is not None:
            y = F.conv2d(x, _cast(self.kernel, dtype), padding=self.padding)
        else:
            y = conv2d_tf(x, _cast(self.kernel, dtype), self.stride,
                          self.pad_mode)
        if self.biases is not None:
            y = y + _cast(self.biases, dtype).view(1, -1, 1, 1)
        if self.bn:
            # batch statistics over (N, W, H) in f32, biased variance —
            # padded columns and duplicated pad rows included — unless the
            # moving statistics are asked for
            y32 = y.float()
            if moving_bn:
                mean = self.bn_mean.view(1, -1, 1, 1)
                var = self.bn_var.view(1, -1, 1, 1)
            else:
                mean, var = batch_moments(y32, bn_group)
                if bn_collect is not None:
                    bn_collect.append((self, mean.detach().reshape(-1),
                                       var.detach().reshape(-1)))
            y32 = (y32 - mean) * torch.rsqrt(var + BN_EPS)
            y = y32 * self.bn_gamma.view(1, -1, 1, 1) \
                + self.bn_beta.view(1, -1, 1, 1)
            y = y.to(x.dtype)
        if self.relu:
            y = F.relu(y)
        return y


def max_pool(x, k_w, k_h, s_w=None, s_h=None, padding='VALID'):
    """Max pool over (W, H), window (k_w, k_h), stride (s_w, s_h) (the
    window by default); ``SAME`` pads with -inf, TF's way."""
    s = (k_w if s_w is None else s_w, k_h if s_h is None else s_h)
    pads = _tf_pads(x, (k_w, k_h), s, padding)
    if pads is not None:
        x = F.pad(x, pads, value=float('-inf'))
    return F.max_pool2d(x, (k_w, k_h), s)


def avg_pool(x, k_w, k_h, s_w, s_h, padding='SAME'):
    """Average pool as the JAX ``avg_pool_apply``: the window's sum over
    ``k_w * k_h``, the ``SAME`` padding's zeros counted (not the mean of
    the valid cells)."""
    pads = _tf_pads(x, (k_w, k_h), (s_w, s_h), padding)
    if pads is not None:
        x = F.pad(x, pads)
    return F.avg_pool2d(x, (k_w, k_h), (s_w, s_h))


def pool_out_shape(in_shape, k_h, k_w, s_h, s_w, padding='SAME'):
    """Output shape of a pool on a JAX-layout shape (N, A1, A2, C)."""
    n, a1, a2, c = in_shape
    return (n, out_dim(a1, k_h, s_h, padding), out_dim(a2, k_w, s_w, padding),
            c)


def channel_dim(x):
    """The channel axis: 1 of a 4-D tensor [N, C, A1, A2] (the JAX
    layout's last axis), else the last."""
    return 1 if x.dim() == 4 else x.dim() - 1


def channel_view(p, x):
    """A per-channel vector ``p`` shaped to broadcast over ``x``."""
    return p.view(1, -1, 1, 1) if x.dim() == 4 else p


class FC(nn.Module):
    """Fully connected: ``weights`` [in, out] (glorot, as the JAX ``fc``)
    and ``biases``; on a 4-D tensor it maps the channel axis, as the JAX
    matmul does on NHWC's last. The matmul runs in the compute dtype and
    adds the f32 bias."""

    def __init__(self, d, num_out, relu=True, generator=None):
        super().__init__()
        self.relu = relu
        self.weights = nn.Parameter(torch.empty(d, num_out))
        _glorot_(self.weights, d, num_out, generator)
        self.biases = nn.Parameter(torch.zeros(num_out))

    def forward(self, x, dtype=None):
        four = x.dim() == 4
        if four:
            x = x.permute(0, 2, 3, 1)
        y = _cast(x, dtype) @ _cast(self.weights, dtype) + self.biases
        if self.relu:
            y = F.relu(y)
        return y.permute(0, 3, 1, 2) if four else y


def softmax(x):
    """Softmax over the channel axis (the JAX last axis)."""
    return torch.softmax(x, dim=channel_dim(x))


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A bijective hash of 32-bit values (xor-shift-multiply rounds), on
    Python ints or int64 tensors holding values below ``2**32``: each
    multiplier is below ``2**31``, so no product passes ``2**63``."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def dropout_key(seed, layer, step):
    """The key of one dropout layer's masks at one step: a hash of the
    seed (``RNG_SEED``), the layer's place among the net's dropout layers
    and the step (an int, or an integer tensor on the device, such as the
    solver's update count), as the JAX solver's ``fold_in(PRNGKey(seed),
    step)`` split once a dropout layer. An int64 tensor on ``step``'s
    device when ``step`` is a tensor."""
    base = _mix32(_mix32(int(seed) & _M32) ^ int(layer))
    if torch.is_tensor(step):
        return _mix32((step.to(torch.int64) & _M32) ^ base)
    return torch.tensor(_mix32((int(step) & _M32) ^ base), dtype=torch.int64)


def dropout_mask(shape, keep_prob, key, device):
    """Bool mask of ``shape``, each element True with probability
    ``keep_prob``: a counter-based hash of ``key`` and the element's flat
    index, so the same key gives the same mask on any device, eagerly or
    replayed from a CUDA graph."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix32(_mix32(idx) ^ key.to(device))
    return (h < int(round(keep_prob * 2.0 ** 32))).view(shape)


def dropout(x, keep_prob, training, key):
    """Inverted dropout: each element kept with probability ``keep_prob``
    and scaled by ``1 / keep_prob``; the identity outside training or at
    ``keep_prob >= 1``. The mask is :func:`dropout_mask` of ``key``
    (:func:`dropout_key`); it cannot match ``jax.random``'s."""
    if not training or keep_prob >= 1.0:
        return x
    keep = dropout_mask(tuple(x.shape), keep_prob, key, x.device)
    return torch.where(keep, x / keep_prob, 0.0).to(x.dtype)


def reshape_squeeze(x, d):
    """[N, C, W', H'] -> [N, W'*H', d]: the JAX ``[N, W', H', C]`` reshape."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, d)


class LSTMCell(nn.Module):
    """One direction's weights: ``w`` [D, 4H], ``u`` [H, 4H], ``bias`` [4H]."""

    def __init__(self, d, h, generator=None):
        super().__init__()
        kernel = torch.empty(d + h, 4 * h)
        _glorot_(kernel, d + h, 4 * h, generator)
        self.w = nn.Parameter(kernel[:d].clone())
        self.u = nn.Parameter(kernel[d:].clone())
        self.bias = nn.Parameter(torch.zeros(4 * h))


def _cell_weights(cell, dtype):
    return {k: _cast(p, dtype) for k, p in
            (('w', cell.w), ('u', cell.u), ('bias', cell.bias))}


class BiLSTM(nn.Module):
    """BiLSTM of ``num_hids // 2`` units per direction + f32 projection to
    ``nclasses``; returns time-major logits [T, N, C]. ``recurrence`` is
    ``(cells, x [N, T, D], lens) -> [N, T, 2H]``: the fused kernels
    (``ops/rnn.py:bilstm``) unless a comparison passes another, such as
    the plain two-scan pair (``rnn.bilstm_scan_pair``,
    ``tools/attrib_step.py``)."""

    def __init__(self, d, num_hids, nclasses, generator=None,
                 recurrence=None):
        super().__init__()
        self.recurrence = recurrence or rnn.bilstm
        h = num_hids // 2
        self.cells = nn.ModuleDict({'fw': LSTMCell(d, h, generator),
                                    'bw': LSTMCell(d, h, generator)})
        self.weights = nn.Parameter(torch.empty(num_hids, nclasses))
        std = math.sqrt(0.01 / ((num_hids + nclasses) / 2.0))
        with torch.no_grad():
            nn.init.trunc_normal_(self.weights, std=std / 0.87962566,
                                  a=-2 * std / 0.87962566,
                                  b=2 * std / 0.87962566, generator=generator)
        self.biases = nn.Parameter(torch.zeros(nclasses))

    def forward(self, x, lens, dtype=None):
        x = _cast(x, dtype)
        cells = {name: _cell_weights(cell, dtype)
                 for name, cell in self.cells.items()}
        out = self.recurrence(cells, x, lens)               # [N, T, num_hids]
        # projection in f32: a small matmul, and CTC wants f32 logits
        logits = out.float() @ self.weights + self.biases
        return logits.transpose(0, 1)                       # [T, N, C]


class LSTM(nn.Module):
    """``num_layers`` stacked unidirectional LSTMs of ``num_hids`` units
    (the first reads width ``d``) + f32 projection to ``nclasses``; returns
    time-major logits [T, N, C]. Counterpart of the JAX ``lstm_init`` /
    ``lstm_apply``: cells in the list ``cells``, projection ``weights``
    drawn truncated-normal with stddev 0.1, zero ``biases``."""

    def __init__(self, d, num_hids, num_layers, nclasses, generator=None):
        super().__init__()
        self.cells = nn.ModuleList(
            LSTMCell(d if i == 0 else num_hids, num_hids, generator)
            for i in range(num_layers))
        self.weights = nn.Parameter(torch.empty(num_hids, nclasses))
        with torch.no_grad():
            nn.init.trunc_normal_(self.weights, std=0.1, a=-0.2, b=0.2,
                                  generator=generator)
        self.biases = nn.Parameter(torch.zeros(nclasses))

    def forward(self, x, lens, dtype=None):
        x_tm = _cast(x, dtype).transpose(0, 1)
        for cell in self.cells:
            x_tm = rnn.lstm(_cell_weights(cell, dtype), x_tm, lens)
        # projection in f32, as in the BiLSTM layer; already time-major
        return x_tm.float() @ self.weights + self.biases


class StackedBiLSTM(nn.Module):
    """``num_layers`` BiLSTMs of ``num_hids // 2`` units a direction, each
    reading the one before's ``num_hids`` outputs (the first reads width
    ``d``), + f32 projection to ``nclasses``; returns time-major logits
    [T, N, C]. The stack runs time-major (``rnn.bilstm_tm``), so no layout
    copy lies between two layers. ``forget_bias`` is added to the forget
    gate as in :class:`BiLSTM` (0: PyTorch's LSTM). In training, inverted
    dropout of ``keep_prob`` acts on each layer's input and on the
    projection's, each masked by its key of ``keys`` (``num_layers + 1``
    of :func:`dropout_key`; None: no dropout).

    Parameters ``layers.<i>.cells.{fw,bw}.{w,u,bias}`` (:class:`LSTMCell`,
    so the weight bridge writes each as the JAX cell's ``kernel``),
    ``weights`` [num_hids, nclasses] and ``biases``, drawn as
    :class:`BiLSTM`'s. Under a ``torch.profiler`` trace the head is the span
    ``rnn.stack``, and each call adds its layers times its frames, padding
    included (``num_layers * N * T``), to the counter ``rnn.layer_frames``.
    """

    def __init__(self, d, num_hids, num_layers, nclasses, forget_bias=1.0,
                 keep_prob=1.0, generator=None):
        super().__init__()
        h = num_hids // 2
        self.forget_bias, self.keep_prob = float(forget_bias), keep_prob
        self.layers = nn.ModuleList(
            nn.ModuleDict({'cells': nn.ModuleDict({
                'fw': LSTMCell(d if i == 0 else num_hids, h, generator),
                'bw': LSTMCell(d if i == 0 else num_hids, h, generator)})})
            for i in range(num_layers))
        self.weights = nn.Parameter(torch.empty(num_hids, nclasses))
        std = math.sqrt(0.01 / ((num_hids + nclasses) / 2.0)) / 0.87962566
        with torch.no_grad():
            nn.init.trunc_normal_(self.weights, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        self.biases = nn.Parameter(torch.zeros(nclasses))

    def forward(self, x, lens, dtype=None, keys=None):
        """``x`` [N, T, d] -> f32 logits [T, N, nclasses]."""
        n, t_len = x.shape[:2]
        count('rnn.layer_frames', len(self.layers) * n * t_len)
        on = self.training and keys is not None
        with span('rnn.stack'):
            x_tm = _cast(x, dtype).transpose(0, 1)
            for i, layer in enumerate(self.layers):
                if on:
                    x_tm = dropout(x_tm, self.keep_prob, True, keys[i])
                cells = {name: _cell_weights(cell, dtype)
                         for name, cell in layer['cells'].items()}
                x_tm = rnn.bilstm_tm(cells, x_tm, lens, self.forget_bias)
            if on:
                x_tm = dropout(x_tm, self.keep_prob, True, keys[-1])
            # projection in f32, as in the BiLSTM layer; already time-major
            return x_tm.float() @ self.weights + self.biases
