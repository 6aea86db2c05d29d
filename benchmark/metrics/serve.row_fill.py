"""Images asked for over the rows the served programs computed, padding
included, as the program counts them (``serve.images``, ``serve.rows``)."""

import importlib

LAYER = 'serving export engine/serve.py'
UNIT = '%'
MOVES = 'decode_images_per_s'


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    if not c.get('serve.rows'):
        return None
    return 100.0 * c.get('serve.images', 0) / c['serve.rows']
