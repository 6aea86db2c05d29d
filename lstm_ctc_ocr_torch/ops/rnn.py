"""Length-masked (bi)directional LSTM: plain twins and the BiLSTM dispatch.

Counterpart of the JAX package's ``ops/rnn.py``. The cell follows the TF1
LSTMCell contract: gate order (i, j, f, o), ``forget_bias`` added at compute
time, tanh activations, no peepholes. ``sequence_length`` semantics follow
``bidirectional_dynamic_rnn``: outputs at ``t >= len`` are zero and the state
stops updating; the backward direction runs over the length-reversed
sequence.

A cell's weights are ``{'w': [D, 4H], 'u': [H, 4H], 'bias': [4H]}``: the JAX
package's ``kernel [D+H, 4H]`` split into its input and recurrent halves
(``engine/checkpoint.py:params_from_flat``).

:func:`bilstm` is the model's BiLSTM (:func:`bilstm_tm` its time-major
form, which a stack of them chains): one input projection for both
directions, then ``rnn_cuda.bilstm_fwd`` — the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor — inside a
``torch.autograd.Function`` whose backward is ``rnn_cuda.bilstm_bwd``
(counterpart of the JAX package's ``_bi_core`` custom VJP).
:func:`lstm` is the unidirectional scan of the stacked ``lstm`` head, the
counterpart of ``rnn_pallas.lstm_scan``: the projection, then
``rnn_cuda.lstm_fwd`` with ``rnn_cuda.lstm_bwd`` as its gradient. Where no
gradient is needed (decoding, and so ``torch.export``) both call the same
kernels as the custom ops of ``ops/custom_ops.py`` instead, which save no
residuals and which an exported program can hold.
:func:`lstm_scan` is its plain twin (the JAX ``lax.scan`` version), and
:func:`bilstm_scan_pair` (two scans and two reversal gathers, over either
scan) is the portable formulation the tests hold the fused BiLSTM against.
"""

from __future__ import annotations

import torch

from . import custom_ops, rnn_cuda


def _cell_step(h, c, x_proj, u, bias, forget_bias=1.0):
    """One LSTM step given the precomputed input projection ``x_proj``."""
    gates = x_proj + h @ u + bias
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


def lstm_scan(cell, x_tm, lens, forget_bias=1.0):
    """Unidirectional masked LSTM over time-major [T, N, D] -> [T, N, H],
    computed in the input dtype like the JAX ``lax.scan`` version."""
    t_len, n, d = x_tm.shape
    w, u, bias = cell['w'], cell['u'], cell['bias']
    x_proj = (x_tm.reshape(t_len * n, d) @ w).reshape(t_len, n, -1)
    h = torch.zeros(n, u.shape[0], dtype=x_tm.dtype, device=x_tm.device)
    c = torch.zeros_like(h)
    outs = []
    for t in range(t_len):
        new_h, new_c = _cell_step(h, c, x_proj[t], u, bias, forget_bias)
        live = (t < lens)[:, None].to(h.dtype)
        h = live * new_h + (1.0 - live) * h
        c = live * new_c + (1.0 - live) * c
        outs.append(live * new_h)
    return torch.stack(outs) if outs else x_proj.new_zeros(0, n, u.shape[0])


def reverse_sequence(x_tm, lens):
    """Per-example reversal of the first ``lens[n]`` frames of [T, N, ...]
    (``tf.reverse_sequence``); frames past ``lens`` keep their position."""
    t_len, n = x_tm.shape[:2]
    t_idx = torch.arange(t_len, device=x_tm.device)[:, None].expand(t_len, n)
    lens = lens.to(torch.int64)[None, :]
    src = torch.where(t_idx < lens, lens - 1 - t_idx, t_idx)
    src = src.reshape(src.shape + (1,) * (x_tm.dim() - 2)).expand(x_tm.shape)
    return torch.gather(x_tm, 0, src)


def bilstm_scan_pair(cells, x, lens, forget_bias=1.0, scan=lstm_scan):
    """BiLSTM [N, T, D] -> [N, T, 2H] as two masked scans and two
    ``reverse_sequence`` gathers. ``scan`` is :func:`lstm_scan` or
    :func:`lstm` (the JAX package picks it with ``select_scan()``)."""
    x_tm = x.transpose(0, 1)
    out_fw = scan(cells['fw'], x_tm, lens, forget_bias)
    x_rev = reverse_sequence(x_tm, lens)
    out_bw = reverse_sequence(scan(cells['bw'], x_rev, lens, forget_bias),
                              lens)
    return torch.cat([out_fw, out_bw], dim=-1).transpose(0, 1)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _BiLSTMCore(torch.autograd.Function):
    """``bilstm_fwd`` with ``bilstm_bwd`` as its gradient; :func:`bilstm`
    applies it only where some input needs a gradient, so the forward
    always saves the residuals."""

    @staticmethod
    def forward(ctx, xpf, xpb, uf, ub, bf, bb, lens, forget_bias):
        of, gf, hf, cf, ob, gb, hb, cb = rnn_cuda.bilstm_fwd(
            xpf, xpb, uf, ub, bf, bb, lens, forget_bias, save_residuals=True)
        ctx.save_for_backward(gf, hf, cf, gb, hb, cb, uf, ub, lens)
        return of, ob

    @staticmethod
    def backward(ctx, dof, dob):
        gf, hf, cf, gb, hb, cb, uf, ub, lens = ctx.saved_tensors
        dxf, dxb, duf, dbf, dub, dbb = rnn_cuda.bilstm_bwd(
            dof.to(gf.dtype).contiguous(), dob.to(gb.dtype).contiguous(),
            gf, hf, cf, gb, hb, cb, uf, ub, lens)
        return (dxf, dxb, duf.to(uf.dtype), dub.to(ub.dtype),
                dbf.to(uf.dtype), dbb.to(ub.dtype), None, None)


def bilstm(cells, x, lens, forget_bias=1.0):
    """Bidirectional masked LSTM, fused.

    Args:
      cells: ``{'fw': cell, 'bw': cell}``, each of hidden size H.
      x:     [N, T, D] batch-major input.
      lens:  [N] int32 valid frame counts.
    Returns:
      [N, T, 2H] concat(fw, bw) outputs, zero past ``lens``.
    """
    return bilstm_tm(cells, x.transpose(0, 1), lens,
                     forget_bias).transpose(0, 1)


def bilstm_tm(cells, x_tm, lens, forget_bias=1.0):
    """:func:`bilstm` time-major in and out: [T, N, D] -> [T, N, 2H]. A
    stack of BiLSTMs passes each layer's output to the next as it is, with
    no layout copy between layers."""
    t_len, n, d = x_tm.shape
    fw, bw = cells['fw'], cells['bw']
    four_h = fw['u'].shape[1]
    w = torch.cat([fw['w'], bw['w']], dim=1)              # [D, 8H], one matmul
    xp = (x_tm.reshape(t_len * n, d) @ w).reshape(t_len, n, 2 * four_h)
    weights = (fw['u'], bw['u'], fw['bias'], bw['bias'])
    if _needs_grad(xp, *weights):
        of, ob = _BiLSTMCore.apply(xp[:, :, :four_h], xp[:, :, four_h:],
                                   *weights, lens, forget_bias)
    else:
        of, ob = custom_ops.bilstm_fwd(xp, *weights, lens, forget_bias)
    return torch.cat([of, ob], dim=-1)


class _LSTMCore(torch.autograd.Function):
    """``lstm_fwd`` with ``lstm_bwd`` as its gradient; :func:`lstm` applies
    it only where some input needs a gradient, so the forward always saves
    the residuals."""

    @staticmethod
    def forward(ctx, x_proj, u, bias, lens, forget_bias):
        out, gates, hs, cs = rnn_cuda.lstm_fwd(x_proj, u, bias, lens,
                                               forget_bias,
                                               save_residuals=True)
        ctx.save_for_backward(gates, hs, cs, u, lens)
        return out

    @staticmethod
    def backward(ctx, dout):
        gates, hs, cs, u, lens = ctx.saved_tensors
        dx, du, db = rnn_cuda.lstm_bwd(dout.to(gates.dtype).contiguous(),
                                       gates, hs, cs, u, lens)
        return dx, du.to(u.dtype), db.to(u.dtype), None, None


def lstm(cell, x_tm, lens, forget_bias=1.0):
    """Unidirectional masked LSTM over time-major [T, N, D] -> [T, N, H]:
    one input projection, then the recurrence as ``rnn_cuda.lstm_fwd`` (the
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor). Same
    contract as :func:`lstm_scan`; ``lens`` is [N] int32."""
    t_len, n, d = x_tm.shape
    x_proj = (x_tm.reshape(t_len * n, d) @ cell['w']).reshape(t_len, n, -1)
    if _needs_grad(x_proj, cell['u'], cell['bias']):
        return _LSTMCore.apply(x_proj, cell['u'], cell['bias'], lens,
                               forget_bias)
    return custom_ops.lstm_fwd(x_proj, cell['u'], cell['bias'], lens,
                               forget_bias)
