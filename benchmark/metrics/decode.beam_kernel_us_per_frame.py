"""The beam search kernel's device time per frame: the device time of the
kernels named ``beam_kernel`` (``csrc/beam.cu``) in the traced window over
the program's counter ``beam.frames`` (the time-major frames of each beam
call), in microseconds.

Where the search runs as that one kernel a call, its device time waits
inside the decode's readback, so the host-side beam readers see only the
enqueue; this reads the kernel itself. None where the trace holds no such
kernel (a program without it, or the CPU) or the counter is missing."""

import importlib

from benchmark import trace

LAYER = 'eval driver and decoders engine/test.py ops/beam.py ops/decoder.py'
UNIT = 'us'
MOVES = 'decode_images_per_s'

PREFIXES = ('beam_kernel',)


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    dev, n = trace.kernel_seconds(summary, PREFIXES)
    if not n or not c.get('beam.frames'):
        return None
    return 1e6 * dev / c['beam.frames']
