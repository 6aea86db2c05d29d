"""The CRNN: LSTM_train / LSTM_test (counterpart of the JAX package's
``models/crnn.py``), one ``nn.Module`` whose submodules carry the JAX layer
names, so checkpoint keys map 1:1 (``engine/checkpoint.py``)::

    data [N, W, 32] (width-major; the width axis is CTC time)
    conv1 3x3x64            -> pool 2x2    [N,  64, W/2, 16]
    conv2 3x3x128           -> pool 2x2    [N, 128, W/4,  8]
    conv3_1, conv3_2 3x3x256 -> pool 1x2   [N, 256, W/4,  4]
    conv4_1, conv4_2 3x3x512 (BN) -> 1x2   [N, 512, W/4,  2]
    conv5 2x2x512 VALID, no relu           [N, 512, W/4-1, 1]
    reshape_squeeze                        [N, T=W/4-1, 512]
    logits: BiLSTM 2x(NUM_HID/2) + proj    [T, N, NCLASSES]

A subclass chooses another head by overriding ``make_head``, as a user of
the JAX package writes a ``Network`` subclass ending in ``.lstm(...)``
instead of ``.bi_lstm(...)``; the stacked unidirectional model is::

    class StackedLSTM(LSTM_train):
        def make_head(self, num_hid, nclasses, generator):
            return LSTM(512, num_hid, 2, nclasses, generator)

and goes to ``engine.train.train_net(network, ...)`` and
``engine.test.test_net(..., model=network)`` as it is; it takes the conv
lowering as the base class does, ``StackedLSTM(..., conv_impl=
str(cfg.CONV_IMPL))``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BiLSTM, ConvSingle, max_pool, reshape_squeeze


class LSTM_train(nn.Module):
    """Training graph; the eval graph ``LSTM_test`` is identical."""

    def __init__(self, nchannels=1, num_hid=512, nclasses=64, generator=None,
                 conv_impl='xla'):
        """``conv_impl`` is ``CONV_IMPL``: ``'shifted'`` lowers conv2 to
        conv5 to shifted matmuls (``models/layers.py:ConvSingle``)."""
        super().__init__()
        g, c = generator, conv_impl
        self.conv1 = ConvSingle(nchannels, 64, 3, generator=g, conv_impl=c)
        self.conv2 = ConvSingle(64, 128, 3, generator=g, conv_impl=c)
        self.conv3_1 = ConvSingle(128, 256, 3, generator=g, conv_impl=c)
        self.conv3_2 = ConvSingle(256, 256, 3, generator=g, conv_impl=c)
        self.conv4_1 = ConvSingle(256, 512, 3, bn=True, generator=g,
                                  conv_impl=c)
        self.conv4_2 = ConvSingle(512, 512, 3, bn=True, generator=g,
                                  conv_impl=c)
        self.conv5 = ConvSingle(512, 512, 2, relu=False, padding='VALID',
                                generator=g, conv_impl=c)
        self.logits = self.make_head(num_hid, nclasses, g)

    def make_head(self, num_hid, nclasses, generator):
        """The recurrent head over the [N, T, 512] features: a module with
        ``forward(x, lens, dtype) -> [T, N, nclasses]`` f32 logits and a
        projection ``weights`` (the one tensor of the head that carries L2
        weight decay). A subclass may return ``layers.LSTM`` instead."""
        return BiLSTM(512, num_hid, nclasses, generator=generator)

    def forward(self, data, time_step_len, dtype=None, moving_bn=False,
                bn_collect=None, bn_group=None):
        """``data`` [N, W, H] (f32, or uint8 raw pixels divided by 255 here),
        ``time_step_len`` [N] int32 -> time-major f32 logits [T, N, C].
        ``dtype`` is the compute dtype (None: f32); ``moving_bn`` selects the
        moving BN statistics instead of the batch's; ``bn_collect`` (a list)
        receives each BN layer's batch statistics (``layers.ConvSingle``);
        ``bn_group`` is the process group whose ranks' rows share them (data
        parallelism, ``parallel/mesh.py``)."""
        if data.dtype == torch.uint8:
            data = data.float() / 255.0
        x = data.unsqueeze(1)                       # [N, 1, W, H]
        x = max_pool(self.conv1(x, dtype), 2, 2)
        x = max_pool(self.conv2(x, dtype), 2, 2)
        x = self.conv3_2(self.conv3_1(x, dtype), dtype)
        x = max_pool(x, 1, 2)
        x = self.conv4_1(x, dtype, moving_bn, bn_collect, bn_group)
        x = self.conv4_2(x, dtype, moving_bn, bn_collect, bn_group)
        x = max_pool(x, 1, 2)
        x = self.conv5(x, dtype)
        return self.logits(reshape_squeeze(x, 512), time_step_len, dtype)

    def regularization_loss(self, weight_decay):
        """Sum of the L2 penalties ``weight_decay * sum(w^2) / 2`` over the
        conv kernels and the recurrent head's projection weights, in f32;
        zero when ``weight_decay <= 0``. LSTM cell weights, biases and the
        BN scale and shift carry none."""
        tensors = [m.kernel for m in self.children()
                   if isinstance(m, ConvSingle)] + [self.logits.weights]
        total = tensors[0].new_zeros((), dtype=torch.float32)
        if weight_decay <= 0:
            return total
        for w in tensors:
            total = total + weight_decay * 0.5 * torch.sum(
                torch.square(w.float()))
        return total


class LSTM_test(LSTM_train):
    """Eval graph: the same topology."""
