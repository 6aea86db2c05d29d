"""CTC prefix beam search as one hand-written CUDA kernel per decode call.

The kernel is ``csrc/beam.cu``; its header says what bounds it on an H100
and what its design does about it. It replaces no TPU kernel (the JAX
package's beam search is XLA); its plain version is
``ops/beam.py:beam_decode_reference``, whose ids it returns entry for entry.

:func:`beam_decode` launches the kernel for CUDA tensors and raises for
anything else; ``ops/custom_ops.py``'s op ``lstm_ctc_ocr_torch::beam_decode``
chooses between it and the plain version by device. ``beam_decode.launches``
counts kernel launches. Shapes past the kernel's limits raise, naming the
limit; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiler import launched
from . import _build

MAX_CLASSES = 1024        # C: torch's one-warp log-softmax layout
MAX_BEAM_WIDTH = 256      # K: one thread a beam
MAX_CANDIDATES = 16384    # K * (C + 1): the selection's candidates
MAX_NODES = 65535         # T * K: the prefix trie's 16-bit node links
MAX_SHARED_BYTES = 232448  # an H100 block's shared memory
_WARPS = 8                # frames a log-softmax refill holds


def shared_bytes(t_len: int, k: int, c: int) -> int:
    """The kernel's shared memory for T, K, C: the total of
    ``csrc/beam.cu:layout`` (a ``Beam`` is 28 bytes there, which a
    ``static_assert`` holds), which the launch checks against this.
    :func:`kernel_shared_bytes` asks the built kernel for its own total."""
    def a(x):
        return (x + 15) // 16 * 16
    return (a(4 * k * (c + 1)) + a(4 * _WARPS * c) + a(2 * k * 28)
            + a(16 * k) + a(2 * 256 * 4) + a(8 * 256) + a(32)
            + a(2 * t_len) + a(4 * (1 + t_len * k)))


def check_limits(t_len: int, k: int, c: int, blank: int = 0) -> None:
    """Raise ``ValueError`` naming the first limit T, K, C pass."""
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError('beam kernel: C = {} classes, limit 1..{} '
                         '(MAX_CLASSES)'.format(c, MAX_CLASSES))
    if not 1 <= k <= MAX_BEAM_WIDTH:
        raise ValueError('beam kernel: beam width K = {}, limit 1..{} '
                         '(MAX_BEAM_WIDTH)'.format(k, MAX_BEAM_WIDTH))
    if not 0 <= blank < c:
        raise ValueError('beam kernel: blank {} is not a class of C = {}'
                         .format(blank, c))
    if k * (c + 1) > MAX_CANDIDATES:
        raise ValueError('beam kernel: K * (C + 1) = {} candidates a frame, '
                         'limit {} (MAX_CANDIDATES)'
                         .format(k * (c + 1), MAX_CANDIDATES))
    if t_len * k > MAX_NODES:
        raise ValueError('beam kernel: T * K = {} prefix nodes, limit {} '
                         '(MAX_NODES)'.format(t_len * k, MAX_NODES))
    need = shared_bytes(t_len, k, c)
    if need > MAX_SHARED_BYTES:
        raise ValueError('beam kernel: T = {}, K = {}, C = {} need {} bytes '
                         'of shared memory, limit {} (MAX_SHARED_BYTES)'
                         .format(t_len, k, c, need, MAX_SHARED_BYTES))


def kernel_shared_bytes(t_len: int, k: int, c: int) -> int:
    """``csrc/beam.cu:layout``'s total, from the built library (the card's
    tests hold :func:`shared_bytes` to it)."""
    fn = _build.library('beam').ctc_beam_shared_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(t_len, k, c)


def _entry():
    fn = _build.library('beam').ctc_beam_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def beam_decode(logits, lens, beam_width=16, blank=0, merge_repeated=False):
    """``ops/beam.py:beam_decode_reference``'s contract on the card.

    Args:
      logits: [N, T, C] f32 or bf16 CUDA tensor, the class axis contiguous
              (other strides are taken as they are).
      lens:   [N] int32 valid frame counts, contiguous, on the same device.
    Returns:
      [N, T] int32 top-beam ids, 0-padded (``merge_repeated`` applied).
    """
    if logits.dim() != 3:
        raise ValueError('logits: expected [N, T, C], got {}'
                         .format(tuple(logits.shape)))
    n, t_len, c = logits.shape
    k = int(beam_width)
    check_limits(t_len, k, c, blank)
    if logits.device.type != 'cuda':
        raise ValueError('the beam kernel runs on CUDA tensors, got {}'
                         .format(logits.device))
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('logits: expected float32 or bfloat16, got {}'
                         .format(logits.dtype))
    if lens.dtype != torch.int32 or lens.device != logits.device \
            or tuple(lens.shape) != (n,) or not lens.is_contiguous():
        raise ValueError('lens: expected contiguous ({},) int32 on {}, got {} '
                         '{} on {}'.format(n, logits.device, tuple(lens.shape),
                                           lens.dtype, lens.device))
    if logits.stride(2) != 1:
        logits = logits.contiguous()
    out = torch.empty(n, t_len, dtype=torch.int32, device=logits.device)
    if n == 0 or t_len == 0:
        return out
    err = _entry()(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        logits.stride(0), logits.stride(1), lens.data_ptr(), out.data_ptr(),
        n, t_len, k, c, int(blank), int(bool(merge_repeated)),
        shared_bytes(t_len, k, c),
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            'ctc_beam_decode kernel launch failed: cudaError {} (shared '
            'memory: shared_bytes() {}, csrc/beam.cu:layout() {})'
            .format(err, shared_bytes(t_len, k, c),
                    kernel_shared_bytes(t_len, k, c)))
    launched(beam_decode)
    return out


beam_decode.launches = 0
