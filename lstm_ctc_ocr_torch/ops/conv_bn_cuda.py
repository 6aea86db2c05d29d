"""Fused conv3x3 + bias + training-mode batch norm + ReLU, forward only: the
hand-written CUDA kernel and its plain twin.

Counterpart of the JAX package's ``ops/conv_bn_pallas.py``
(``conv3x3_bn_relu`` / ``_kernel``): the A/B partner of the unfused conv4_1
/ conv4_2 layers (``models/layers.py:ConvSingle`` with ``bn=True``), timed
by ``tools/bench_conv_bn.py``. ``csrc/conv_bn.cu``'s header says what bounds
it on an H100 and how its design answers that.

The contract is stated in the port's layout: activations ``[N, C, W, H]``
and conv kernels ``[C_out, C_in, 3, 3]`` (``models/layers.py``). The CUDA
kernel works channels-last; the entry point makes ``x`` channels-last (no
copy when it already is, in memory) and casts and reorders the 3x3 kernel
into the nine taps with two launches of its own, inside the wrapper's
time, and the wrapper returns a ``[N, C_out, W, H]`` tensor whose memory is
channels-last. The wrapper allocates the output and one scratch buffer
whose size the CUDA side states (``conv_bn_scratch_bytes``).

Numerics, as in the TPU kernel: the nine taps accumulate in f32 and round
once, with the bias, to the compute dtype; the batch statistics come from
the *rounded* activations, in f32, in the one-pass ``E[x^2] - E[x]^2`` form
clamped at 0 (the unfused layer takes the two-pass variance); scale, shift
and ReLU run in f32 and round once more.

``conv3x3_bn_relu`` launches the kernel for CUDA tensors and runs
``conv3x3_bn_relu_reference`` for CPU tensors; it never falls back from one
to the other. ``conv3x3_bn_relu.launches`` counts launches (one per call).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_SUPPORTED = (torch.bfloat16, torch.float32)
CHANNEL_STEP = 16      # the kernel's kStep: C_in is padded to a multiple


def conv3x3_bn_relu_reference(x, kernel, bias, gamma, beta, eps=1e-3):
    """Plain PyTorch version of the kernel.

    Args:
      x:      [N, C_in, W, H] in the compute dtype (bf16 or f32).
      kernel: [C_out, C_in, 3, 3]; cast to ``x.dtype``.
      bias, gamma, beta: [C_out]; used in f32.
    Returns:
      relu(batchnorm(conv_same(x, kernel) + bias)) as [N, C_out, W, H] in
      ``x.dtype``, batch statistics over (N, W, H).
    """
    n, ci, w, h = x.shape
    co = kernel.shape[0]
    dt = x.dtype
    kernel = kernel.to(dt)
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # [N, W+2, H+2, Ci]
    acc = torch.zeros(n * w * h, co, dtype=torch.float32, device=x.device)
    for dw in range(3):
        for dh in range(3):
            rows = xp[:, dw:dw + w, dh:dh + h, :].reshape(n * w * h, ci)
            # products of the compute dtype's values, f32 accumulation
            acc += rows.float() @ kernel[:, :, dw, dh].float().t()
    y32 = (acc + bias.float()).to(dt).float()               # single rounding
    count = float(n * w * h)
    mean = y32.sum(dim=0) * (1.0 / count)
    var = torch.clamp((y32 * y32).sum(dim=0) * (1.0 / count) - mean * mean,
                      min=0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    out = torch.relu(y32 * scale + shift).to(dt)
    return out.reshape(n, w, h, co).permute(0, 3, 1, 2)


def _scratch_bytes(dtype, n, w, h, ci, co, channels_last):
    """Bytes of scratch ``csrc/conv_bn.cu`` needs at this shape (channels-
    last x, taps, per-tile statistics); the layout lives in the CUDA file."""
    fn = _build.library('conv_bn').conv_bn_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_longlong
    return fn(int(dtype == torch.bfloat16), n, w, h, ci, co,
              int(channels_last))


def _entry(dtype):
    lib = _build.library('conv_bn')
    fn = getattr(lib, 'conv_bn_bf16' if dtype == torch.bfloat16
                 else 'conv_bn_f32')
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, ctypes.c_int] + [p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def conv3x3_bn_relu(x, kernel, bias, gamma, beta, eps=1e-3):
    """Fused conv3x3 (SAME) + bias + batch norm on batch statistics + ReLU.

    Same contract as :func:`conv3x3_bn_relu_reference`. CPU tensors run the
    plain version; CUDA tensors launch ``csrc/conv_bn.cu`` (the layout of x
    and of the taps, the conv with its partial statistics, their reduction,
    the normalisation: one entry point) or raise. Any C_in: where it is not
    a multiple of :data:`CHANNEL_STEP`, ``x`` and the kernel get zero input
    channels up to one (a copy of ``x``, in the wrapper's time)."""
    if x.device.type == 'cpu':
        return conv3x3_bn_relu_reference(x, kernel, bias, gamma, beta, eps)
    if x.device.type != 'cuda':
        raise ValueError('conv3x3_bn_relu runs on CUDA or CPU tensors, got {}'
                         .format(x.device))
    dtype, dev = x.dtype, x.device
    if dtype not in _SUPPORTED:
        raise TypeError('conv3x3_bn_relu takes bf16 or f32, got {}'
                        .format(dtype))
    if x.dim() != 4 or kernel.dim() != 4 \
            or tuple(kernel.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError('expected x [N, C_in, W, H] and kernel [C_out, C_in, '
                         '3, 3], got {} and {}'.format(tuple(x.shape),
                                                       tuple(kernel.shape)))
    n, ci, w, h = x.shape
    co = kernel.shape[0]
    for name, tns in (('kernel', kernel), ('bias', bias), ('gamma', gamma),
                      ('beta', beta)):
        if tns.device != dev or (name != 'kernel'
                                 and tuple(tns.shape) != (co,)):
            raise ValueError('{}: expected a [{}] tensor on {}, got {} on {}'
                             .format(name, co, dev, tuple(tns.shape),
                                     tns.device))
    if ci % CHANNEL_STEP:
        # the kernel takes channels in steps of CHANNEL_STEP: zero channels,
        # in x and in the kernel's C_in, add zero to every sum
        pad = (0, 0, 0, 0, 0, CHANNEL_STEP - ci % CHANNEL_STEP)
        return conv3x3_bn_relu(F.pad(x, pad), F.pad(kernel, pad), bias,
                               gamma, beta, eps)
    channels_last = x.permute(0, 2, 3, 1).is_contiguous()
    if not channels_last:
        x = x.contiguous()              # [N, C, W, H] rows for the kernel
    kernel, bias, gamma, beta = (t.float().contiguous()
                                 for t in (kernel, bias, gamma, beta))
    y = torch.empty(n, w, h, co, dtype=dtype, device=dev)
    if y.numel():
        scratch = torch.empty(
            _scratch_bytes(dtype, n, w, h, ci, co, channels_last),
            dtype=torch.uint8, device=dev)
        err = _entry(dtype)(
            x.data_ptr(), int(channels_last),
            *(t.data_ptr() for t in (kernel, bias, gamma, beta, y, scratch)),
            n, w, h, ci, co, float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError('conv_bn kernel launch failed: cudaError {}'
                               .format(err))
        conv3x3_bn_relu.launches += 1
    return y.permute(0, 3, 1, 2)


conv3x3_bn_relu.launches = 0
