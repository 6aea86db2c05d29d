"""Kernels 1 and 2's least time for the traced steps' work (``flops.py``,
each row's own frames; the forward keeps its residuals) over their device
time in the trace."""

from benchmark import flops, trace

LAYER = 'BiLSTM kernels ops/rnn_cuda.py'
UNIT = '%'
MOVES = 'train_images_per_s'

PREFIXES = ('bilstm_fwd', 'bilstm_bwd')


def read(summary):
    c = summary['counts']
    dev, n = trace.kernel_seconds(summary, PREFIXES)
    if not n or not c.get('widths'):
        return None
    h, b = c['num_hid'] // 2, c['batch']
    lens = [flops.frames(w) for w in c['widths']]
    bound = 0.0
    for s in range(0, len(lens), b):
        step = lens[s:s + b]
        bound += flops.bilstm_fwd_bound(step, h, c['dtype'], True)[0]
        bound += flops.bilstm_bwd_bound(step, h, c['dtype'])[0]
    return 100.0 * bound / dev
