"""Fused masked BiLSTM forward: the hand-written CUDA kernel and its plain twin.

Counterpart of the JAX package's ``ops/rnn_pallas.py`` (``_bi_fwd_call`` /
``_bi_fwd_kernel``). The kernel is ``csrc/bilstm_fwd.cu``; its header says
what bounds it on an H100 and how its design answers that. The input
projection ``x @ [W_fw | W_bw]`` stays outside the kernel, as it stayed
outside the TPU kernel (one large matmul).

``bilstm_fwd`` launches the kernel for CUDA tensors and runs
``bilstm_fwd_reference`` for CPU tensors; it never falls back from one to
the other. ``bilstm_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SUPPORTED = (torch.bfloat16, torch.float32)
MAX_HIDDEN = 256      # one thread per hidden unit: kMaxHidden in the kernel


def bilstm_fwd_reference(xpf, xpb, uf, ub, bf, bb, lens, forget_bias=1.0,
                         save_residuals=False):
    """Plain PyTorch version of the kernel: the same ascending (fw) and
    descending (bw) masked walks over physical time.

    Args:
      xpf, xpb: [T, N, 4H] input projections (bf16 or f32).
      uf, ub:   [H, 4H] recurrent weights; bf, bb: [4H] biases.
      lens:     [N] int32 valid lengths.
    Returns:
      ``(of, ob)``, each [T, N, H] in the input dtype and zero past
      ``lens``; with ``save_residuals``, the TPU kernel's eight outputs
      ``(of, gf, hf, cf, ob, gb, hb, cb)``: post-activation gates
      [T, N, 4H] (i, j, f, o) and the masked h and c carries [T, N, H].
    """
    t_len, n, four_h = xpf.shape
    h_dim = four_h // 4
    rdt = xpf.dtype
    lens = lens.to(torch.int64)
    results = []
    for xp, u, b, steps in ((xpf, uf, bf, range(t_len)),
                            (xpb, ub, bb, reversed(range(t_len)))):
        u32 = u.float()
        b32 = b.float()
        h = torch.zeros(n, h_dim, dtype=torch.float32, device=xp.device)
        c = torch.zeros_like(h)
        out = torch.zeros(t_len, n, h_dim, dtype=rdt, device=xp.device)
        if save_residuals:
            gates = torch.zeros(t_len, n, four_h, dtype=rdt, device=xp.device)
            hs = torch.zeros_like(out)
            cs = torch.zeros_like(out)
        for t in steps:
            # h enters the product in the compute dtype; f32 accumulation
            g = xp[t].float() + h.to(u.dtype).float() @ u32 + b32
            i = torch.sigmoid(g[:, :h_dim])
            j = torch.tanh(g[:, h_dim:2 * h_dim])
            f = torch.sigmoid(g[:, 2 * h_dim:3 * h_dim] + forget_bias)
            o = torch.sigmoid(g[:, 3 * h_dim:])
            c_new = f * c + i * j
            h_new = o * torch.tanh(c_new)
            live = (lens > t).to(torch.float32)[:, None]
            h = live * h_new + (1.0 - live) * h
            c = live * c_new + (1.0 - live) * c
            out[t] = (live * h_new).to(rdt)
            if save_residuals:
                gates[t] = torch.cat([i, j, f, o], dim=1).to(rdt)
                hs[t] = h.to(rdt)
                cs[t] = c.to(rdt)
        results += [out, gates, hs, cs] if save_residuals else [out]
    return tuple(results)


def _pack_u(u, vec):
    """[H, 4H] -> [H/vec, 4H, vec]: the kernel's 16-byte load layout."""
    h_dim, four_h = u.shape
    return u.reshape(h_dim // vec, vec, four_h).transpose(1, 2).contiguous()


def _entry(dtype):
    lib = _build.library('bilstm_fwd')
    fn = getattr(lib, 'bilstm_fwd_bf16' if dtype == torch.bfloat16
                 else 'bilstm_fwd_f32')
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, p, ctypes.c_longlong] + [p] * 13
                       + [ctypes.c_int] * 3 + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def bilstm_fwd(xpf, xpb, uf, ub, bf, bb, lens, forget_bias=1.0,
               save_residuals=False):
    """Fused masked BiLSTM forward, both directions in one launch.

    Same contract as :func:`bilstm_fwd_reference`. ``xpf``/``xpb`` may be
    column slices of one [T, N, 8H] projection (rows need only share a
    stride). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/bilstm_fwd.cu`` or raise.
    """
    if xpf.device.type == 'cpu':
        return bilstm_fwd_reference(xpf, xpb, uf, ub, bf, bb, lens,
                                    forget_bias, save_residuals)
    if xpf.device.type != 'cuda':
        raise ValueError('bilstm_fwd runs on CUDA or CPU tensors, got {}'
                         .format(xpf.device))
    t_len, n, four_h = xpf.shape
    h_dim = four_h // 4
    dtype = xpf.dtype
    if dtype not in _SUPPORTED:
        raise TypeError('bilstm_fwd takes bf16 or f32, got {}'.format(dtype))
    vec = 16 // xpf.element_size()
    for name, tns, shape in (('xpb', xpb, xpf.shape), ('uf', uf, (h_dim, four_h)),
                             ('ub', ub, (h_dim, four_h)), ('bf', bf, (four_h,)),
                             ('bb', bb, (four_h,))):
        if tns.dtype != dtype or tns.device != xpf.device \
                or tuple(tns.shape) != tuple(shape):
            raise ValueError('{}: expected {} {} on {}, got {} {} on {}'.format(
                name, tuple(shape), dtype, xpf.device, tuple(tns.shape),
                tns.dtype, tns.device))
    if lens.dtype != torch.int32 or lens.device != xpf.device \
            or tuple(lens.shape) != (n,):
        raise ValueError('lens: expected [{}] int32 on {}'.format(n, xpf.device))
    if four_h % 4 or not 0 < h_dim <= MAX_HIDDEN or h_dim % vec:
        raise ValueError('hidden size {} unsupported: needs H <= {} and a '
                         'multiple of {}'.format(h_dim, MAX_HIDDEN, vec))
    row_stride = xpf.stride(1)
    for tns in (xpf, xpb):
        if tns.stride(2) != 1 or tns.stride(0) != n * row_stride \
                or tns.stride(1) != row_stride:
            raise ValueError('xpf/xpb need unit column stride and a shared '
                             'row stride')
    bf, bb, lens = bf.contiguous(), bb.contiguous(), lens.contiguous()
    upf, upb = _pack_u(uf, vec), _pack_u(ub, vec)

    def new(width):
        return torch.empty(t_len, n, width, dtype=dtype, device=xpf.device)

    of, ob = new(h_dim), new(h_dim)
    gf, hf, cf, gb, hb, cb = (
        [new(four_h), new(h_dim), new(h_dim), new(four_h), new(h_dim),
         new(h_dim)] if save_residuals else [None] * 6)
    if t_len and n:
        ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
        err = _entry(dtype)(
            ptr(xpf), ptr(xpb), row_stride, ptr(upf), ptr(upb), ptr(bf),
            ptr(bb), ptr(lens), ptr(of), ptr(ob), ptr(gf), ptr(gb), ptr(hf),
            ptr(hb), ptr(cf), ptr(cb), t_len, n, h_dim, float(forget_bias),
            torch.cuda.current_stream(xpf.device).cuda_stream)
        if err != 0:
            raise RuntimeError('bilstm_fwd kernel launch failed: cudaError {}'
                               .format(err))
        bilstm_fwd.launches += 1
    if save_residuals:
        return of, gf, hf, cf, ob, gb, hb, cb
    return of, ob


bilstm_fwd.launches = 0
