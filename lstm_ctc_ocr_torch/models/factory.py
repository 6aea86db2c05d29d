"""Model factory: name -> model (counterpart of the JAX package's
``models/factory.py``)."""

from __future__ import annotations

from .crnn import LSTM_test, LSTM_train
from .htr import HTR_test, HTR_train


def get_network(name: str, cfg, generator=None):
    """Build 'LSTM_train' / 'LSTM_test' with the widths and the conv
    lowering (``CONV_IMPL``) ``cfg`` gives: the CRNN, or where
    ``NET_NAME`` is ``htr`` Puigcerver's handwriting model
    (``models/htr.py``) with ``IMG_HEIGHT``, ``TRAIN.NUM_LAYERS`` and
    ``RNG_SEED`` too. The CRNN ignores ``TRAIN.NUM_LAYERS``, as the JAX
    package's does."""
    htr = str(cfg.NET_NAME).lower() == 'htr'
    kinds = {'LSTM_train': HTR_train if htr else LSTM_train,
             'LSTM_test': HTR_test if htr else LSTM_test}
    if name not in kinds:
        raise KeyError('Unknown network name: {}'.format(name))
    dims = dict(nchannels=int(cfg.NCHANNELS), num_hid=int(cfg.TRAIN.NUM_HID),
                nclasses=int(cfg.NCLASSES), generator=generator,
                conv_impl=str(cfg.CONV_IMPL))
    if htr:
        dims.update(num_layers=int(cfg.TRAIN.NUM_LAYERS),
                    img_height=int(cfg.IMG_HEIGHT),
                    dropout_seed=int(cfg.RNG_SEED))
    return kinds[name](**dims)
