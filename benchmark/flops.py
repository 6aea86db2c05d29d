"""Operations and bytes from shapes: the model's FLOPs and the least time
of the hand kernels' work on one NVIDIA H100 SXM, counted over each
image's own width and each example's own label, never over the bucket or
the store's padding, so that a change that pads less cannot lower them.

Published peaks (NVIDIA's data sheet, dense, at the 700 W limit): 989
TFLOP/s in bf16, 67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s of
HBM. A run reports the card's power limit beside the shares read against
them.

The model's FLOPs count the convolutions, the BiLSTM's input and recurrent
products and the projection, two operations a multiply-add; batch norm,
pools, activations, the loss and the solver are left out. A training step
counts the backward too: twice the forward for every product, less the
products whose gradient nothing needs (conv1's input gradient, the first
step's gradient into the zero initial state).

The arithmetic of the kernels' bounds is that of the card's smoke test
(``chip_smoke.py``'s ``bound_ms``, ``bilstm_bwd_bound_ms`` and
``ctc_bound_ms``), with every count taken over live frames and each
example's own ``S = 2L + 1`` states.
"""

from __future__ import annotations

PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {'bfloat16': 2, 'float32': 4}

# (name, c_in, c_out, kernel) of the seven convs; c_in None: the image
CONVS = (('conv1', None, 64, 3), ('conv2', 64, 128, 3),
         ('conv3_1', 128, 256, 3), ('conv3_2', 256, 256, 3),
         ('conv4_1', 256, 512, 3), ('conv4_2', 512, 512, 3),
         ('conv5', 512, 512, 2))


def frames(width, pool_scale=4, offset=-1):
    """The CTC frames of an image ``width`` wide: ``W // 4 - 1``."""
    return width // pool_scale + offset


def conv_flops(width, height=32, nchannels=1):
    """``{conv: forward FLOPs}`` of one image ``width`` wide."""
    w, h = width, height
    out = {}
    for name, c_in, c_out, k in CONVS:
        c_in = c_in or nchannels
        if name == 'conv5':                       # 2x2 VALID
            wo, ho = w - 1, h - 1
        else:                                     # 3x3 SAME
            wo, ho = w, h
        out[name] = 2 * c_in * c_out * k * k * wo * ho
        if name in ('conv1', 'conv2'):
            w, h = w // 2, h // 2
        elif name in ('conv3_2', 'conv4_2'):
            h = h // 2
    return out


def model_flops(width, num_hid=512, nclasses=64, train=False, height=32):
    """FLOPs of one image ``width`` wide: the forward, or with ``train``
    forward and backward."""
    convs = conv_flops(width, height)
    t = frames(width)
    h = num_hid // 2
    proj_in = 2 * t * 512 * 8 * h                  # both directions' x @ W
    rec = 2 * (2 * t * h * 4 * h)                  # both directions' h @ U
    proj_out = 2 * t * num_hid * nclasses
    fwd = sum(convs.values()) + proj_in + rec + proj_out
    if not train:
        return fwd
    # backward: dX and dW of every product; conv1's dX and the first
    # step's dh (into the zero state) are never needed
    rec_bwd = 2 * (2 * t * h * 4 * h) + 2 * (2 * max(t - 1, 0) * h * 4 * h)
    bwd = (2 * (sum(convs.values()) - convs['conv1']) + convs['conv1']
           + 2 * proj_in + rec_bwd + 2 * proj_out)
    return fwd + bwd


def _bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def bilstm_fwd_bound(lens, hidden, dtype='bfloat16', residuals=False):
    """Least seconds of kernel 1's work (``bilstm_fwd``) over rows of
    ``lens`` live frames, ``hidden`` units a direction: the two
    directions' input projections and U read once and outputs written once
    (with ``residuals`` also the gates, h and c a training step keeps), or
    the live steps' recurrent products over the dtype's peak."""
    es, h = BYTES[dtype], hidden
    live = sum(lens)
    read = 2 * (live * 4 * h + h * 4 * h + 4 * h) * es + 4 * len(lens)
    written = 2 * live * h * es
    if residuals:
        written += 2 * live * (4 * h + 2 * h) * es
    flops = 2 * live * 2 * h * 4 * h
    return _bound(read + written, flops, PEAK_FLOPS[dtype])


def bilstm_bwd_bound(lens, hidden, dtype='bfloat16'):
    """Least seconds of kernel 2's work (``bilstm_bwd``): the outputs'
    gradients, gates, h, c and U read once, the projections' gradients
    written once and dU, db in f32; or the live steps' two products a
    direction (dg U^T, h^T dg) over the dtype's peak."""
    es, h = BYTES[dtype], hidden
    live = sum(lens)
    read = (2 * live * h + 2 * live * 4 * h + 4 * live * h
            + 2 * h * 4 * h) * es + 4 * len(lens)
    written = 2 * live * 4 * h * es + 4 * (2 * h * 4 * h + 2 * 4 * h)
    flops = 2 * live * 4 * h * 4 * h
    return _bound(read + written, flops, PEAK_FLOPS[dtype])


def ctc_bound(lens, label_lens, backward):
    """Least seconds of kernel 3's (``backward`` False) or kernel 4's work
    over examples of ``lens`` live frames and ``label_lens`` labels: the
    gathered log-probabilities [T, S] and the three masks read once, the
    alphas and logZ written once (the backward: alphas, logZ and lengths
    read, the gradient written), in f32; or about 14 operations a frame and
    state (three exp, one log, adds and maxima) over the f32 peak."""
    cube = sum(4 * t * (2 * ln + 1) for t, ln in zip(lens, label_lens))
    masks = sum(3 * 4 * (2 * ln + 1) for ln in label_lens)
    n = len(lens)
    nbytes = cube + masks + cube + 4 * n
    if backward:
        nbytes += cube + 4 * n
    ops = sum(14 * t * (2 * ln + 1) for t, ln in zip(lens, label_lens))
    return _bound(nbytes, ops, PEAK_FLOPS['float32'])
