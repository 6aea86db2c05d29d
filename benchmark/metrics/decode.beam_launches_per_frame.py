"""Device kernels of the beam search per frame: kernels whose start on the
card lies inside one of the program's ``eval.beam`` spans (the trace puts
both on one clock), over its counter ``beam.frames``.

Kernels are matched to the search by time, not by the launch that queued
them. That holds while the card runs each kernel as soon as it is queued,
as in a host-bound decode (the device idles about nine tenths of the
time). Once the card lags the host, kernels queued before a span (the
forward's) start inside it and count, and the search's own that start
after it closes do not: the trace's launch events would be needed to
count by launch."""

import bisect
import importlib

LAYER = 'eval driver and decoders engine/test.py ops/beam.py ops/decoder.py'
UNIT = 'launches/frame'
MOVES = 'decode_images_per_s'


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    beams = [(s, e) for n, s, e in summary['spans'] if n == 'eval.beam']
    if not c.get('beam.frames') or not beams or not summary['kernels']:
        return None
    starts = sorted(s for _, s, _ in summary['kernels'])
    inside = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
                 for s, e in beams)
    return inside / c['beam.frames']
