"""CTC forward and backward recursions as hand-written CUDA kernels, and the
loss that dispatches to them.

Counterpart of the JAX package's ``ops/ctc_pallas.py`` (``_run_forward`` /
``_fwd_kernel`` and ``_run_backward`` / ``_bwd_kernel``) and of
``ops/ctc.py:select_ctc_loss``. The kernels are in ``csrc/ctc.cu``; its
header says what bounds them on an H100 and what their design does about
it. Their plain versions are ``ops/ctc.py:ctc_forward_reference`` and
``ctc_backward_reference``.

:func:`ctc_forward` and :func:`ctc_backward` launch the kernel for CUDA
tensors and run the plain version for CPU tensors; neither falls back from
one to the other. ``ctc_forward.launches`` / ``ctc_backward.launches`` count
kernel launches.

:func:`ctc_loss` is the training loss: the gather and the scatter in
tensor ops around the two recursions. Both run one warp per example up to
:data:`WARP_MAX_STATES` extended states (labels of up to 31 characters) and
one block per example past that, each thread walking several states where
S passes 1024. So they take labels of any length; the JAX package's kernel
stops at 63 characters and hands longer labels to its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiler import launched
from . import _build, ctc

WARP_MAX_STATES = 64      # S up to which both kernels run one warp an example


def _entry(name, n_ptrs):
    fn = getattr(_build.library('ctc'), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, g, others):
    """Raise on what the kernels do not take; returns (N, T, S). ``others``
    lists ``(label, tensor, 'cube' | 'row' | 'vec', dtype)``: the tensors
    beside ``g`` of shape [N, T, S], [N, S] or [N]."""
    if g.device.type != 'cuda':
        raise ValueError('{} runs on CUDA or CPU tensors, got {}'.format(
            name, g.device))
    if g.dim() != 3 or not g.shape[2] > 0:
        raise ValueError('g: expected [N, T, S] with S >= 1, got {}'
                         .format(tuple(g.shape)))
    n, t_len, s_len = g.shape
    shapes = {'cube': (n, t_len, s_len), 'row': (n, s_len), 'vec': (n,)}
    for label, tns, kind, dtype in [('g', g, 'cube', torch.float32)] + others:
        if tns.dtype != dtype or tns.device != g.device \
                or tuple(tns.shape) != shapes[kind] \
                or not tns.is_contiguous():
            raise ValueError('{}: expected contiguous {} {} on {}, got {} {} '
                             'on {}'.format(label, shapes[kind], dtype,
                                            g.device, tuple(tns.shape),
                                            tns.dtype, tns.device))
    return n, t_len, s_len


def _masks(skip, valid, final):
    return [(label, tns, 'row', torch.float32) for label, tns in
            (('skip', skip), ('valid', valid), ('final', final))]


def ctc_forward(g, skip, valid, final):
    """Alpha recursion: ``(logz [N], alphas [N, T, S])``.

    Same contract as :func:`ctc.ctc_forward_reference`. CPU tensors run the
    plain version; CUDA tensors launch ``csrc/ctc.cu:ctc_fwd`` or raise.
    """
    if g.device.type == 'cpu':
        return ctc.ctc_forward_reference(g, skip, valid, final)
    n, t_len, s_len = _check('ctc_forward', g, _masks(skip, valid, final))
    logz = torch.empty(n, dtype=torch.float32, device=g.device)
    alphas = torch.empty_like(g)
    if n and t_len:
        err = _entry('ctc_fwd', 6)(
            g.data_ptr(), skip.data_ptr(), valid.data_ptr(),
            final.data_ptr(), logz.data_ptr(), alphas.data_ptr(), n, t_len,
            s_len, torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            raise RuntimeError('ctc_fwd kernel launch failed: cudaError {}'
                               .format(err))
        launched(ctc_forward)
    return logz, alphas


def ctc_backward(g, skip, valid, final, alphas, logz, lens):
    """Beta recursion and posteriors: ``grad_g`` [N, T, S].

    Same contract as :func:`ctc.ctc_backward_reference`. CPU tensors run
    the plain version; CUDA tensors launch ``csrc/ctc.cu:ctc_bwd`` or raise.
    """
    if g.device.type == 'cpu':
        return ctc.ctc_backward_reference(g, skip, valid, final, alphas,
                                          logz, lens)
    n, t_len, s_len = _check(
        'ctc_backward', g, _masks(skip, valid, final)
        + [('alphas', alphas, 'cube', torch.float32),
           ('logz', logz, 'vec', torch.float32),
           ('lens', lens, 'vec', torch.int32)])
    grad = torch.empty_like(g)
    if n and t_len:
        # the block kernel's two beta rows an example (past the warp form)
        beta = (torch.empty(n, 2, s_len, dtype=torch.float32, device=g.device)
                if s_len > WARP_MAX_STATES else None)
        err = _entry('ctc_bwd', 9)(
            g.data_ptr(), skip.data_ptr(), valid.data_ptr(),
            final.data_ptr(), alphas.data_ptr(), logz.data_ptr(),
            lens.data_ptr(), grad.data_ptr(),
            None if beta is None else beta.data_ptr(), n, t_len, s_len,
            torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            raise RuntimeError('ctc_bwd kernel launch failed: cudaError {}'
                               .format(err))
        launched(ctc_backward)
    return grad


ctc_forward.launches = 0
ctc_backward.launches = 0


def ctc_loss(logits, labels, label_lens, logit_lens):
    """Per-example CTC negative log-likelihood (``ops/ctc.py:ctc_loss``
    contract) through :func:`ctc_forward` / :func:`ctc_backward`."""
    return ctc.ctc_loss_with(ctc_forward, ctc_backward, logits, labels,
                             label_lens, logit_lens)
