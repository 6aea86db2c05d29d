"""The host's beam search per frame: the program's ``eval.beam`` spans
over its counter ``beam.frames`` (the time-major frames of each beam
call), in ms.

Read from a traced run, the value includes the profiler's own cost of
every operation and kernel launch of the search (about 1.7 times the
untraced host time on the H100's host), so it falls by more than the
untraced time when the search makes fewer launches: compare it only with
itself, and take a gain from the end-to-end metric."""

import importlib

LAYER = 'eval driver and decoders engine/test.py ops/beam.py ops/decoder.py'
UNIT = 'ms'
MOVES = 'decode_images_per_s'


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    ns = sum(e - s for n, s, e in summary['spans'] if n == 'eval.beam')
    if not c.get('beam.frames') or not ns:
        return None
    return ns / 1e6 / c['beam.frames']
