"""The CRNN's layers as ``nn.Module``s with the JAX package's parameter names.

Counterpart of the JAX package's ``models/layers.py`` for the main path:
``conv_single`` (bias, batch norm, relu), ``max_pool``, ``reshape_squeeze``
and ``bi_lstm`` with its f32 projection.

Layout: the JAX package runs images as ``[N, W, H, C]`` with HWIO kernels
whose *first* spatial axis runs over image width. The port runs
``[N, C, W, H]`` — the same two spatial axes in the same order — with
kernels ``[C_out, C_in, kW, kH]`` (``hwio.permute(3, 2, 0, 1)``), so a SAME
3x3 conv is ``padding=1``, the VALID 2x2 conv5 is ``padding=0`` and a
``(1, 2)`` pool pools the height only.

Cast points follow ``layers.py:66-107,154-160``: the conv and ``+bias`` run
in the compute dtype, batch norm runs in f32 on the compute-dtype output
and casts back before relu, pools run in the compute dtype, and the
BiLSTM's projection runs in f32 on its (compute-dtype) outputs.
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

    def forward(self, x, dtype=None, moving_bn=False):
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
                mean = y32.mean(dim=(0, 2, 3), keepdim=True)
                var = y32.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
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


class BiLSTM(nn.Module):
    """BiLSTM of ``num_hids // 2`` units per direction + f32 projection to
    ``nclasses``; returns time-major logits [T, N, C]."""

    def __init__(self, d, num_hids, nclasses, generator=None):
        super().__init__()
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
        cells = {name: {k: _cast(p, dtype) for k, p in
                        (('w', cell.w), ('u', cell.u), ('bias', cell.bias))}
                 for name, cell in self.cells.items()}
        out = rnn.bilstm(cells, x, lens)                    # [N, T, num_hids]
        # projection in f32: a small matmul, and CTC wants f32 logits
        logits = out.float() @ self.weights + self.biases
        return logits.transpose(0, 1)                       # [T, N, C]
