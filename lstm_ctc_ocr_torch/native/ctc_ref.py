"""ctypes binding of the C++ CTC oracle (``native/ctc_ref.cpp``), the port's
copy of the JAX package's ``native/ctc_ref.py``.

:func:`ctc_loss_grad` gives the per-example CTC loss and its gradient with
respect to the logits, in double precision inside, from a C++ source that
shares nothing with the CTC kernels (``csrc/ctc.cu``) or their plain
versions (``ops/ctc.py``): an independent oracle for both. The library is
built with g++ at first use into ``lstm_ctc_ocr_torch/build/``
(``ops/_build.py:host_library``); a missing compiler or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'ctc_ref.cpp')

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ..ops._build import host_library
    lib = host_library(_SRC)
    lib.ctc_loss_grad.restype = ctypes.c_int
    lib.ctc_loss_grad.argtypes = [
        ctypes.POINTER(ctypes.c_float),    # logits
        ctypes.POINTER(ctypes.c_int32),    # labels
        ctypes.POINTER(ctypes.c_int32),    # label_lens
        ctypes.POINTER(ctypes.c_int32),    # logit_lens
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),    # losses out
        ctypes.POINTER(ctypes.c_float),    # grads out (nullable)
    ]
    _lib = lib
    return lib


def ctc_loss_grad(logits: np.ndarray, labels: np.ndarray,
                  label_lens: np.ndarray, logit_lens: np.ndarray,
                  want_grad: bool = True
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Per-example CTC loss [N] (and gradient wrt logits [N, T, C]).

    ``logits`` [N, T, C] f32, ``labels`` [N, L] int32 dense and 0-padded,
    lengths [N] int32. A length outside [0, T] or [0, L], or a label id
    outside [0, C), raises ``AssertionError``; an example with no
    alignment has loss +inf and a zero gradient."""
    lib = _load()
    logits = np.ascontiguousarray(logits, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    label_lens = np.ascontiguousarray(label_lens, np.int32)
    logit_lens = np.ascontiguousarray(logit_lens, np.int32)
    n, t, c = logits.shape
    l_max = labels.shape[1]
    losses = np.zeros((n,), np.float32)
    grads = np.zeros((n, t, c), np.float32) if want_grad else None

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    ret = lib.ctc_loss_grad(
        logits.ctypes.data_as(fp), labels.ctypes.data_as(ip),
        label_lens.ctypes.data_as(ip), logit_lens.ctypes.data_as(ip),
        n, t, c, l_max, losses.ctypes.data_as(fp),
        grads.ctypes.data_as(fp) if want_grad else ctypes.cast(None, fp))
    assert ret == 0, 'ctc_ref returned {}'.format(ret)
    return losses, grads
