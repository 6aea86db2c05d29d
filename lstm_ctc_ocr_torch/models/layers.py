"""The CRNN's layers as ``nn.Module``s with the JAX package's parameter names.

Counterpart of the JAX package's ``models/layers.py`` for the main path:
``conv_single`` (bias, batch norm, relu), ``max_pool``, ``reshape_squeeze``,
``bi_lstm`` with its f32 projection, and the stacked unidirectional
``lstm`` variant.

Layout: the JAX package runs images as ``[N, W, H, C]`` with HWIO kernels
whose *first* spatial axis runs over image width. The port runs
``[N, C, W, H]`` — the same two spatial axes in the same order — with
kernels ``[C_out, C_in, kW, kH]`` (``hwio.permute(3, 2, 0, 1)``), so a SAME
3x3 conv is ``padding=1``, the VALID 2x2 conv5 is ``padding=0`` and a
``(1, 2)`` pool pools the height only.

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

BN_EPS = 1e-3


def _glorot_(t, fan_in, fan_out, generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


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
    """Conv + bias (+ training-mode batch norm) (+ relu), stride 1.

    Parameters ``kernel`` [C_out, C_in, kW, kH], ``biases``, and with
    ``bn`` also ``bn_gamma``/``bn_beta`` and the moving-statistics buffers
    ``bn_mean`` (zeros) / ``bn_var`` (ones) — the JAX ``init_bn_state``.
    """

    def __init__(self, c_i, c_o, k, bn=False, relu=True, padding='SAME',
                 generator=None):
        super().__init__()
        self.bn, self.relu = bn, relu
        self.padding = (k - 1) // 2 if padding == 'SAME' else 0
        self.kernel = nn.Parameter(torch.empty(c_o, c_i, k, k))
        _glorot_(self.kernel, c_i * k * k, c_o * k * k, generator)
        self.biases = nn.Parameter(torch.zeros(c_o))
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
        y = F.conv2d(x, _cast(self.kernel, dtype), padding=self.padding)
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


def max_pool(x, k_w, k_h):
    """VALID max pool with stride = window over (W, H)."""
    return F.max_pool2d(x, (k_w, k_h), (k_w, k_h))


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
