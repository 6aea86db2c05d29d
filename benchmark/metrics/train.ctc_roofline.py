"""Kernels 3 and 4's least time for the traced steps' work (``flops.py``,
each example's own frames and ``2L + 1`` states) over their device time
in the trace."""

from benchmark import flops, trace

LAYER = 'CTC kernels ops/ctc_cuda.py'
UNIT = '%'
MOVES = 'train_images_per_s'

PREFIXES = ('ctc_fwd', 'ctc_bwd')


def read(summary):
    c = summary['counts']
    dev, n = trace.kernel_seconds(summary, PREFIXES)
    if not n or not c.get('widths'):
        return None
    b = c['batch']
    lens = [flops.frames(w) for w in c['widths']]
    bound = 0.0
    for s in range(0, len(lens), b):
        for backward in (False, True):
            bound += flops.ctc_bound(lens[s:s + b], c['label_lens'][s:s + b],
                                     backward)[0]
    return 100.0 * bound / dev
