"""Kernels 1 and 2's least time for the traced steps' work over every
layer of the handwriting model's stack (``flops_htr.bilstm_bound``, each
row's own ``W // 8`` frames; the forward keeps its residuals) over their
device time in the trace."""

from benchmark import flops_htr, trace

LAYER = 'BiLSTM kernels ops/rnn_cuda.py'
UNIT = '%'
MOVES = 'train_images_per_s'

PREFIXES = ('bilstm_fwd', 'bilstm_bwd')


def read(summary):
    c = summary['counts']
    dev, n = trace.kernel_seconds(summary, PREFIXES)
    if not n or not c.get('widths'):
        return None
    d, b = flops_htr.dims(c), c['batch']
    lens = [flops_htr.frames(w) for w in c['widths']]
    bound = sum(flops_htr.bilstm_bound(lens[s:s + b], d['num_hid'] // 2,
                                       d['num_layers'], c['dtype'])
                for s in range(0, len(lens), b))
    return 100.0 * bound / dev
