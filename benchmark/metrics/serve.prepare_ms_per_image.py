"""The host's preprocessing of a served image (resize and bucket padding):
the program's ``serve.prepare`` spans over its counter ``serve.images``,
the images asked for in the traced requests, in ms. The spans are read
from a traced run, so they include the profiler's own cost of each
operation they hold (few here: the resize runs in numpy)."""

import importlib

LAYER = 'serving export engine/serve.py'
UNIT = 'ms'
MOVES = 'decode_p95_ms'


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    ns = sum(e - s for n, s, e in summary['spans'] if n == 'serve.prepare')
    if not c.get('serve.images') or not ns:
        return None
    return ns / 1e6 / c['serve.images']
