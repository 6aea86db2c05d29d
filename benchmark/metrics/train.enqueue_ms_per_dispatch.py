"""The host's time in a K-step dispatch's ``solver.upload`` (the row
indices into the graph's static input) and ``solver.replay`` (the replay
and the outputs' clone) spans, over the program's counter
``solver.dispatches``, in ms.

Read from a traced run, the value includes the profiler's own cost of each
kernel the replay shows in the trace, and is several times the untraced
host time (8.5-15.7 ms traced against 2.7-3.7 ms by a host timer, H100):
compare it only with itself, and take a gain from the end-to-end metric."""

import importlib

LAYER = 'solver dispatch engine/train.py'
UNIT = 'ms'
MOVES = 'train_images_per_s'

SPANS = ('solver.upload', 'solver.replay')


def read(summary):
    c = getattr(importlib.import_module('lstm_ctc_ocr_torch.utils.profiler'),
                'counters', dict)()
    ns = sum(e - s for n, s, e in summary['spans'] if n in SPANS)
    if not c.get('solver.dispatches') or not ns:
        return None
    return ns / 1e6 / c['solver.dispatches']
