"""Convolution as a sum of shifted matmuls (``CONV_IMPL: shifted``).

Counterpart of the JAX package's ``ops/conv.py``: another lowering of the
CNN stack's convolutions, the same function as ``F.conv2d`` with TF
``SAME`` / ``VALID`` padding (``models/layers.py:conv2d_tf``). A KxL conv
is the sum over its K*L taps of a shifted slice of the padded input times
that tap's ``[C_in, C_out]`` weights::

    y = sum_{di,dj}  x_pad[:, :, di::s1, dj::s2] . W[:, :, di, dj]

so every term contracts ``C_in`` over a batch of ``N * OA * OB`` output
positions, whatever the spatial shape, and autograd's backward of it is
matmuls and slices too (no conv-backward op).

The tap sum is one GEMM over the taps: the K*L slices side by side on the
contraction axis (``[N*OA*OB, K*L*C_in]``) against the kernel laid out to
match (``[K*L*C_in, C_out]``). That keeps the JAX lowering's numerics: the
products of the whole tap sum accumulate in f32 and round once, at the
output, as ``dot_general(..., preferred_element_type=f32)`` and the final
cast do there. On CUDA the GEMM runs in the input dtype (bf16 on tensor
cores; cuBLAS accumulates in f32, and split-K reductions in bf16 are
turned off for the call). On the CPU a bf16 GEMM rounds its partial sums
(11 bf16 ulps from the once-rounded sum at K=2304, measured with torch
2.13), so bf16 operands are widened to f32 there and the result rounded
once. f32 operands stay f32 on both.

Callers gate on the contraction's size (``models/layers.py:ConvSingle``
takes this lowering where ``k_h * k_w * c_i >= 256``, the JAX rule), so
the CRNN's conv1 (``c_i = 1``) stays on ``F.conv2d``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

CONV_IMPLS = ('xla', 'shifted')
MIN_CONTRACTION = 256


def pad_amount(in_size: int, k: int, s: int, padding: str):
    """``(before, after, out)`` of one axis under TF ``SAME`` (the odd
    extra cell after) or ``VALID``."""
    if padding == 'VALID':
        return 0, 0, (in_size - k) // s + 1
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2, out


@contextlib.contextmanager
def _f32_reductions(device):
    """cuBLAS bf16 GEMMs reduce split-K partial sums in f32 (one rounding
    of the whole sum) for the time of the block."""
    if device.type != 'cuda':
        yield
        return
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def conv2d_shifted(x, kernel, stride=(1, 1), padding='SAME'):
    """``x`` [N, C_in, A1, A2] conv ``kernel`` [C_out, C_in, k1, k2] ->
    [N, C_out, OA1, OA2] in ``x``'s dtype, by the tap sum; TF ``SAME`` or
    ``VALID`` padding, any stride >= 1, no dilation (the JAX
    ``conv2d_shifted`` in the port's layout)."""
    if padding not in ('SAME', 'VALID'):
        raise ValueError('conv2d_shifted takes SAME or VALID padding, got '
                         '{!r}'.format(padding))
    n, ci, a, b = x.shape
    co, kci, ka, kb = kernel.shape
    if ci != kci:
        raise ValueError('input has {} channels, the kernel {}'.format(
            ci, kci))
    sa, sb = stride
    lo_a, hi_a, oa = pad_amount(a, ka, sa, padding)
    lo_b, hi_b, ob = pad_amount(b, kb, sb, padding)
    xh = x.permute(0, 2, 3, 1)                          # [N, A1, A2, C_in]
    if lo_a or hi_a or lo_b or hi_b:
        xh = F.pad(xh, (0, 0, lo_b, hi_b, lo_a, hi_a))
    taps = [xh[:, di:di + (oa - 1) * sa + 1:sa, dj:dj + (ob - 1) * sb + 1:sb]
            for di in range(ka) for dj in range(kb)]   # each [N, OA, OB, Ci]
    cols = torch.cat(taps, dim=3).reshape(n * oa * ob, ka * kb * ci)
    w = kernel.permute(2, 3, 1, 0).reshape(ka * kb * ci, co)
    wide = x.device.type != 'cuda' and x.dtype != torch.float32
    with _f32_reductions(x.device):
        y = cols.float() @ w.float() if wide else cols @ w
    return y.to(x.dtype).view(n, oa, ob, co).permute(0, 3, 1, 2)
