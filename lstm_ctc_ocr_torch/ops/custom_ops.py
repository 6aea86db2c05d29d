"""The decode kernels as ``torch.library`` custom ops.

``lstm_ctc_ocr_torch::bilstm_fwd`` (kernel 1, ``csrc/bilstm_fwd.cu``) and
``lstm_ctc_ocr_torch::lstm_fwd`` (kernel 5, ``csrc/lstm_fwd.cu``) in their
inference form: no residuals, nothing mutated; and
``lstm_ctc_ocr_torch::beam_decode``, the CTC prefix beam search
(``csrc/beam.cu``, ``ops/beam.py``). The wrappers of
``ops/rnn_cuda.py`` launch the kernels through ``ctypes``, which
``torch.export`` and every tracer other than CUDA-graph capture cannot see
into; as custom ops with shape functions (``register_fake``) they appear in
an exported program as one node each, and the program calls them back when
it runs (``engine/serve.py``). Loading such a program therefore needs this
module imported first.

Each op has two implementations, chosen by the device of its tensors:

* ``cuda``: the hand kernel through its wrapper (``rnn_cuda.bilstm_fwd`` /
  ``rnn_cuda.lstm_fwd`` / ``beam_cuda.beam_decode``), on
  ``torch.cuda.current_stream``. The wrapper counts the launch
  (``bilstm_fwd.launches``, ``lstm_fwd.launches``, ``beam_decode.launches``)
  and raises where the build or the launch fails; a CUDA tensor never
  reaches the plain version. The beam op's also adds the frames it ran to
  the trace counter ``beam.kernel_frames`` (``utils/profiler.py``).
* ``cpu``: the plain version (``rnn_cuda.bilstm_fwd_reference`` /
  ``lstm_fwd_reference`` / ``beam.beam_decode_reference``).

Any other device has no implementation and raises.

``ops/rnn.py`` calls the recurrences' ops whenever no gradient is needed;
training keeps its ``autograd.Function``s, whose forward saves the
residuals. ``ops/beam.py:beam_decode`` calls the beam search's.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from ..utils.profiler import count
from . import beam_cuda, rnn_cuda


@torch.library.custom_op('lstm_ctc_ocr_torch::bilstm_fwd', mutates_args=(),
                         device_types='cpu')
def bilstm_fwd(xp: Tensor, uf: Tensor, ub: Tensor, bf: Tensor, bb: Tensor,
               lens: Tensor, forget_bias: float = 1.0) -> Tuple[Tensor,
                                                               Tensor]:
    """Fused masked BiLSTM forward, both directions.

    Args:
      xp:     [T, N, 8H], both directions' input projections side by side
              (forward in columns :4H, backward in 4H:). The op takes the
              whole projection and cuts the two directions out of it
              itself, so the kernel's contract (two column slices sharing
              one row stride) holds whatever a tracer hands over; the CUDA
              implementation makes ``xp`` contiguous first.
      uf, ub: [H, 4H] recurrent weights; bf, bb: [4H] biases.
      lens:   [N] int32 valid lengths.
    Returns:
      ``(of, ob)``, each [T, N, H] in ``xp``'s dtype, zero past ``lens``.
    """
    four_h = uf.shape[1]
    return rnn_cuda.bilstm_fwd_reference(xp[..., :four_h], xp[..., four_h:],
                                         uf, ub, bf, bb, lens, forget_bias)


@bilstm_fwd.register_kernel('cuda')
def _bilstm_fwd_cuda(xp, uf, ub, bf, bb, lens, forget_bias=1.0):
    xp = xp.contiguous()
    four_h = uf.shape[1]
    return rnn_cuda.bilstm_fwd(xp[..., :four_h], xp[..., four_h:], uf, ub,
                               bf, bb, lens, forget_bias)


@bilstm_fwd.register_fake
def _bilstm_fwd_fake(xp, uf, ub, bf, bb, lens, forget_bias=1.0):
    shape = (xp.shape[0], xp.shape[1], uf.shape[0])
    return xp.new_empty(shape), xp.new_empty(shape)


@torch.library.custom_op('lstm_ctc_ocr_torch::lstm_fwd', mutates_args=(),
                         device_types='cpu')
def lstm_fwd(x_proj: Tensor, u: Tensor, bias: Tensor, lens: Tensor,
             forget_bias: float = 1.0) -> Tensor:
    """Masked unidirectional LSTM recurrence from the input projection.

    Args:
      x_proj: [T, N, 4H]; u: [H, 4H]; bias: [4H]; lens: [N] int32.
    Returns:
      [T, N, H] in ``x_proj``'s dtype, zero past ``lens``.
    """
    return rnn_cuda.lstm_fwd_reference(x_proj, u, bias, lens, forget_bias)


@lstm_fwd.register_kernel('cuda')
def _lstm_fwd_cuda(x_proj, u, bias, lens, forget_bias=1.0):
    return rnn_cuda.lstm_fwd(x_proj, u, bias, lens, forget_bias)


@lstm_fwd.register_fake
def _lstm_fwd_fake(x_proj, u, bias, lens, forget_bias=1.0):
    return x_proj.new_empty((x_proj.shape[0], x_proj.shape[1], u.shape[0]))


@torch.library.custom_op('lstm_ctc_ocr_torch::beam_decode', mutates_args=(),
                         device_types='cpu')
def beam_decode(logits: Tensor, lens: Tensor, beam_width: int, blank: int,
                merge_repeated: bool) -> Tensor:
    """CTC prefix beam search: logits [N, T, C] (f32 or bf16), lens [N]
    int32 -> [N, T] int32 top-beam ids, 0-padded."""
    from .beam import beam_decode_reference  # ops/beam.py imports this module
    return beam_decode_reference(logits, lens, beam_width, blank,
                                 merge_repeated)


@beam_decode.register_kernel('cuda')
def _beam_decode_cuda(logits, lens, beam_width, blank, merge_repeated):
    count('beam.kernel_frames', logits.shape[1])
    return beam_cuda.beam_decode(logits, lens, beam_width, blank,
                                 merge_repeated)


@beam_decode.register_fake
def _beam_decode_fake(logits, lens, beam_width, blank, merge_repeated):
    return logits.new_empty(logits.shape[:2], dtype=torch.int32)
