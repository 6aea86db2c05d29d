"""Kernel 1's least time for the traced decode calls' work (``flops.py``,
the frames of the images asked for) over its device time in the trace."""

from benchmark import flops, trace

LAYER = 'BiLSTM kernels ops/rnn_cuda.py'
UNIT = '%'
MOVES = 'decode_images_per_s'

PREFIXES = ('bilstm_fwd',)


def read(summary):
    c = summary['counts']
    dev, n = trace.kernel_seconds(summary, PREFIXES)
    if not n or not c.get('calls'):
        return None
    h = c['num_hid'] // 2
    bound = sum(flops.bilstm_fwd_bound([flops.frames(w) for w in call], h,
                                       c['dtype'])[0] for call in c['calls'])
    return 100.0 * bound / dev
