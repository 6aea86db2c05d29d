"""The share of the beam search's frames that the CUDA kernel ran: the
program's counter ``beam.kernel_frames`` (the frames of each call of the
beam op's CUDA implementation) over ``beam.frames`` (the frames of each
beam decode call), in %. None where either counter is missing, as at a
program without the kernel."""

import importlib

LAYER = 'eval driver and decoders engine/test.py ops/beam.py ops/decoder.py'
UNIT = '%'
MOVES = 'decode_images_per_s'


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    if not c.get('beam.frames') or not c.get('beam.kernel_frames'):
        return None
    return 100.0 * c['beam.kernel_frames'] / c['beam.frames']
