"""Model factory: name -> model (counterpart of the JAX package's
``models/factory.py``)."""

from __future__ import annotations

from .crnn import LSTM_test, LSTM_train


def get_network(name: str, cfg, generator=None):
    """Build 'LSTM_train' / 'LSTM_test' with the widths and the conv
    lowering (``CONV_IMPL``) ``cfg`` gives."""
    kinds = {'LSTM_train': LSTM_train, 'LSTM_test': LSTM_test}
    if name not in kinds:
        raise KeyError('Unknown network name: {}'.format(name))
    return kinds[name](nchannels=int(cfg.NCHANNELS),
                       num_hid=int(cfg.TRAIN.NUM_HID),
                       nclasses=int(cfg.NCLASSES), generator=generator,
                       conv_impl=str(cfg.CONV_IMPL))
