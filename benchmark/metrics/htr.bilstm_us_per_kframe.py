"""Device microseconds of kernels 1 and 2 in the trace over the thousands
of frames the stacked BiLSTM head computed in the traced window, padding
included: the program's counter ``rnn.layer_frames`` (layers x rows x
frames a call; a CUDA graph's replay adds its capture's count)."""

import importlib

from benchmark import trace

LAYER = 'BiLSTM kernels ops/rnn_cuda.py'
UNIT = 'us'
MOVES = 'train_images_per_s'

PREFIXES = ('bilstm_fwd', 'bilstm_bwd')


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    dev, n = trace.kernel_seconds(summary, PREFIXES)
    if not n or not c.get('rnn.layer_frames'):
        return None
    return dev * 1e6 / (c['rnn.layer_frames'] / 1000.0)
