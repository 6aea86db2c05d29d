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
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BiLSTM, ConvSingle, max_pool, reshape_squeeze


class LSTM_train(nn.Module):
    """Training graph; the eval graph ``LSTM_test`` is identical."""

    def __init__(self, nchannels=1, num_hid=512, nclasses=64, generator=None):
        super().__init__()
        g = generator
        self.conv1 = ConvSingle(nchannels, 64, 3, generator=g)
        self.conv2 = ConvSingle(64, 128, 3, generator=g)
        self.conv3_1 = ConvSingle(128, 256, 3, generator=g)
        self.conv3_2 = ConvSingle(256, 256, 3, generator=g)
        self.conv4_1 = ConvSingle(256, 512, 3, bn=True, generator=g)
        self.conv4_2 = ConvSingle(512, 512, 3, bn=True, generator=g)
        self.conv5 = ConvSingle(512, 512, 2, relu=False, padding='VALID',
                                generator=g)
        self.logits = BiLSTM(512, num_hid, nclasses, generator=g)

    def forward(self, data, time_step_len, dtype=None, moving_bn=False):
        """``data`` [N, W, H] (f32, or uint8 raw pixels divided by 255 here),
        ``time_step_len`` [N] int32 -> time-major f32 logits [T, N, C].
        ``dtype`` is the compute dtype (None: f32); ``moving_bn`` selects the
        moving BN statistics instead of the batch's."""
        if data.dtype == torch.uint8:
            data = data.float() / 255.0
        x = data.unsqueeze(1)                       # [N, 1, W, H]
        x = max_pool(self.conv1(x, dtype), 2, 2)
        x = max_pool(self.conv2(x, dtype), 2, 2)
        x = self.conv3_2(self.conv3_1(x, dtype), dtype)
        x = max_pool(x, 1, 2)
        x = self.conv4_1(x, dtype, moving_bn)
        x = self.conv4_2(x, dtype, moving_bn)
        x = max_pool(x, 1, 2)
        x = self.conv5(x, dtype)
        return self.logits(reshape_squeeze(x, 512), time_step_len, dtype)


class LSTM_test(LSTM_train):
    """Eval graph: the same topology."""
