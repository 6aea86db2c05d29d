"""Operations and bytes from shapes for Puigcerver's handwriting model
(``reference/htr.py``): its FLOPs and the least time of its BiLSTM
kernels' work, counted as ``flops.py`` counts the CRNN's, over each
image's own width (``T = W // 8`` frames) and never over the store's
padding.

The model's FLOPs count the five convs (3x3 SAME at the line's height,
halved by each of the three pools), every BiLSTM layer's input and
recurrent products (the first reads ``(H / 8) * 80`` features a frame, the
rest ``num_hid``) and the projection, two operations a multiply-add; batch
norm, pools, activations, dropout, the loss and the solver are left out. A
training step counts the backward too: twice the forward for every
product, less conv1's input gradient and each layer's first step's
gradient into its zero initial state.
"""

from __future__ import annotations

from . import flops

# (name, filters) of the five conv blocks; the first three end in a pool
CONVS = (('conv1', 16), ('conv2', 32), ('conv3', 48), ('conv4', 64),
         ('conv5', 80))
POOLED = ('conv1', 'conv2', 'conv3')
# the published model, which a trace's counts may override
DIMS = dict(num_hid=512, num_layers=5, nclasses=80, height=128)


def frames(width):
    """The CTC frames of an image ``width`` wide: ``W // 8``."""
    return width // 8


def features(height):
    """Features a frame: ``(height // 8) * 80``."""
    return (height // 8) * CONVS[-1][1]


def conv_flops(width, height=128, nchannels=1):
    """``{conv: forward FLOPs}`` of one image ``width`` wide."""
    w, h, c_in = width, height, nchannels
    out = {}
    for name, c_out in CONVS:
        out[name] = 2 * c_in * c_out * 9 * w * h
        if name in POOLED:
            w, h = w // 2, h // 2
        c_in = c_out
    return out


def model_flops(width, num_hid=512, num_layers=5, nclasses=80, height=128,
                train=False):
    """FLOPs of one image ``width`` wide: the forward, or with ``train``
    forward and backward."""
    convs = conv_flops(width, height)
    t, h = frames(width), num_hid // 2
    proj_in = sum(2 * t * (features(height) if i == 0 else num_hid) * 8 * h
                  for i in range(num_layers))
    rec = num_layers * 2 * (2 * t * h * 4 * h)
    proj_out = 2 * t * num_hid * nclasses
    fwd = sum(convs.values()) + proj_in + rec + proj_out
    if not train:
        return fwd
    rec_bwd = num_layers * (2 * (2 * t * h * 4 * h)
                            + 2 * (2 * max(t - 1, 0) * h * 4 * h))
    bwd = (2 * (sum(convs.values()) - convs['conv1']) + convs['conv1']
           + 2 * proj_in + rec_bwd + 2 * proj_out)
    return fwd + bwd


def dims(counts):
    """The model's sizes from a traced window's counts, the published ones
    where the counts do not give them."""
    return {k: int(counts.get(k, v)) for k, v in DIMS.items()}


def bilstm_bound(lens, hidden, num_layers, dtype='bfloat16'):
    """Least seconds of kernels 1 and 2 over a training step's stack:
    each layer's forward (keeping its residuals) and backward over rows of
    ``lens`` live frames (``flops.bilstm_fwd_bound``,
    ``flops.bilstm_bwd_bound``)."""
    one = (flops.bilstm_fwd_bound(lens, hidden, dtype, True)[0]
           + flops.bilstm_bwd_bound(lens, hidden, dtype)[0])
    return num_layers * one
