"""Puigcerver's handwritten-text recogniser: HTR_train / HTR_test, the CNN +
1D-BLSTM model of J. Puigcerver, "Are Multidimensional Recurrent Layers
Really Necessary for Handwritten Text Recognition?" (ICDAR 2017), as PyLaia
ships it for IAM lines (``egs/iam``)::

    data [N, W, 128] gray text lines (width-major; width is CTC time)
    5 conv blocks, 3x3 stride 1 SAME, 16 / 32 / 48 / 64 / 80 filters, each
    batch norm + LeakyReLU(0.01); blocks 1-3 end in a 2x2 max pool;
    dropout 0.2 on the input of blocks 3-5      [N, 80, W/8, 16]
    reshape_squeeze                             [N, T=W/8, 1280]
    5 x BiLSTM 2 x 256, dropout 0.5 on each layer's input
    dropout 0.5, linear 512 -> NCLASSES (f32)   [T, N, NCLASSES]

``get_network`` builds it where ``NET_NAME`` is ``htr``; ``IMG_HEIGHT``
sets the height (128: 1,280 features a frame), ``TRAIN.NUM_LAYERS`` the
BiLSTMs, ``TRAIN.NUM_HID`` their two directions' units, ``RNG_SEED`` the
dropout masks' seed. Time steps are ``W // 8``: ``POOL_SCALE 8``,
``OFFSET_TIME_STEP 0``. It keeps the CRNN's call contract
(``models/crnn.py``), so the solver, the eval driver and the serving export
run it as they run the CRNN, and ``dropout_step`` as the DSL nets take it
(``models/network.py``): the solver keys the masks by its update count,
so K steps in one CUDA graph draw the masks of K single steps.

Departures from the published model, none of which changes the function
class:

* the LSTM cells take the TF1 gate order (i, j, f, o) and one bias, where
  PyTorch's take (i, f, g, o) and two; the forget bias is 0, as PyTorch's;
* the features of a frame are ordered (H, C) (the port's
  ``reshape_squeeze``), PyLaia's (C, H): a permutation of the first
  layer's input weights' rows;
* batch norm's epsilon is the port's 1e-3 (PyTorch's is 1e-5), the
  variance biased, the moving statistics updated by ``BN_MOMENTUM``;
* the convs carry no bias, which batch norm would cancel;
* dropout masks are the port's hashed masks (``layers.dropout_key``).

Initialisation follows the port's layers (Glorot convs and cells, the
projection as ``layers.BiLSTM``'s); the optimizer, clip and schedule are the
solver's (``engine/train.py``), set by the configuration.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConvSingle, StackedBiLSTM, dropout, dropout_key,
                     max_pool, reshape_squeeze)

# (name, filters) of the five conv blocks
CONVS = (('conv1', 16), ('conv2', 32), ('conv3', 48), ('conv4', 64),
         ('conv5', 80))
POOLED = ('conv1', 'conv2', 'conv3')          # blocks ending in a 2x2 pool
CONV_DROP = ('conv3', 'conv4', 'conv5')       # blocks whose input drops
CONV_KEEP, LSTM_KEEP = 0.8, 0.5
LEAKY_SLOPE = 0.01


class HTR_train(nn.Module):
    """Training graph; the eval graph ``HTR_test`` is identical (dropout
    acts in training mode only)."""

    def __init__(self, nchannels=1, num_hid=512, num_layers=5, nclasses=80,
                 img_height=128, generator=None, conv_impl='xla',
                 dropout_seed=3):
        super().__init__()
        c_in = nchannels
        for name, c_out in CONVS:
            setattr(self, name, ConvSingle(c_in, c_out, 3, bn=True,
                                           relu=False, biased=False,
                                           generator=generator,
                                           conv_impl=conv_impl))
            c_in = c_out
        self.features = (int(img_height) // 8) * c_in
        self.logits = StackedBiLSTM(self.features, num_hid, num_layers,
                                    nclasses, forget_bias=0.0,
                                    keep_prob=LSTM_KEEP, generator=generator)
        self.dropout_seed = int(dropout_seed)
        self._dropout_calls = 0

    def has_dropout(self) -> bool:
        """Dropout draws in training mode (the solver then passes the
        step that keys it)."""
        return True

    def forward(self, data, time_step_len, dtype=None, moving_bn=False,
                bn_collect=None, bn_group=None, dropout_step=None):
        """``data`` [N, W, H] (f32, or uint8 raw pixels divided by 255
        here), ``time_step_len`` [N] int32 -> time-major f32 logits
        [T = W // 8, N, C]. ``dtype``, ``moving_bn``, ``bn_collect`` and
        ``bn_group`` as ``models/crnn.py:LSTM_train.forward``'s.
        ``dropout_step``: the step that keys the dropout masks in training
        (an int or an integer tensor); None takes this net's count of such
        calls, which then moves on by one. The masks' keys are
        ``dropout_key(dropout_seed, i, step)``, ``i`` counting the dropout
        layers in order: the inputs of conv3, conv4, conv5, of each BiLSTM
        and of the projection."""
        if data.dtype == torch.uint8:
            data = data.float() / 255.0
        step = dropout_step
        if step is None and self.training:
            step = self._dropout_calls
            self._dropout_calls += 1
        n_keys = len(CONV_DROP) + len(self.logits.layers) + 1
        keys = None if not self.training else \
            [dropout_key(self.dropout_seed, i, step) for i in range(n_keys)]
        bn = (moving_bn, bn_collect, bn_group)
        x = data.unsqueeze(1)                       # [N, 1, W, H]
        for name, _ in CONVS:
            if keys is not None and name in CONV_DROP:
                x = dropout(x, CONV_KEEP, True, keys[CONV_DROP.index(name)])
            x = F.leaky_relu(getattr(self, name)(x, dtype, *bn), LEAKY_SLOPE)
            if name in POOLED:
                x = max_pool(x, 2, 2)
        feats = reshape_squeeze(x, self.features)   # [N, W/8, 1280]
        return self.logits(feats, time_step_len, dtype,
                           None if keys is None else keys[len(CONV_DROP):])

    def regularization_loss(self, weight_decay):
        """Sum of the L2 penalties ``weight_decay * sum(w^2) / 2`` over the
        conv kernels and the projection weights, in f32; zero when
        ``weight_decay <= 0``. The cells, BN scales and shifts carry
        none."""
        tensors = [getattr(self, name).kernel for name, _ in CONVS] \
            + [self.logits.weights]
        total = tensors[0].new_zeros((), dtype=torch.float32)
        if weight_decay <= 0:
            return total
        for w in tensors:
            total = total + weight_decay * 0.5 * torch.sum(
                torch.square(w.float()))
        return total


class HTR_test(HTR_train):
    """Eval graph: the same topology."""
