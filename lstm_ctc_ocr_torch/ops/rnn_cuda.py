"""Masked LSTM recurrences, forward and backward: the hand-written CUDA
kernels and their plain twins.

Counterpart of the JAX package's ``ops/rnn_pallas.py``:

* the fused BiLSTM, ``_bi_fwd_call`` / ``_bi_fwd_kernel``
  (``csrc/bilstm_fwd.cu``) and ``_bi_bwd_call`` / ``_bi_bwd_kernel``
  (``csrc/bilstm_bwd.cu``);
* the unidirectional scan of the stacked ``lstm`` head, ``_fwd_call`` /
  ``_fwd_kernel`` (``csrc/lstm_fwd.cu``) and ``_bwd_call`` / ``_bwd_kernel``
  (``csrc/lstm_bwd.cu``).

Each source's header says what bounds it on an H100 and how its design
answers that. The input projection ``x @ W`` and its backward stay outside
the kernels, as they stayed outside the TPU kernels (large matmuls).

``bilstm_fwd`` / ``bilstm_bwd`` / ``lstm_fwd`` / ``lstm_bwd`` launch a
kernel for CUDA tensors and run ``*_reference`` for CPU tensors; they never
fall back from one to the other. Each wrapper's ``launches`` counts its
launches (one per call). They take any hidden size H up to
:data:`MAX_HIDDEN`, in bf16 and f32. :func:`kernel_path` says which kernel of
the source runs:

* ``cluster`` -- bf16 up to :data:`CLUSTER_HIDDEN`: thread-block clusters
  that hold U in shared memory and copy it there from U as it is
  (:func:`units_per_block`, :func:`cluster_report`); a shape for which no
  cluster fits the card raises, nothing degrades to another kernel;
* ``wide`` -- f32 at every width, bf16 past that (``csrc/lstm_wide.cuh``):
  one block a batch row whose threads walk the units, U packed by
  :func:`_pack_u` and streamed from L2 every step.

H that is not a multiple of 16 bytes of the type (8 in bf16, 4 in f32) is
zero-padded to one by :func:`resize_hidden` and the results cut back: a
padded unit starts at c = 0, gets j = tanh(0) = 0, so its c and h stay 0,
and its rows of U are zero, so it feeds nothing into the real units.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiler import launched
from . import _build

_SUPPORTED = (torch.bfloat16, torch.float32)
CLUSTER_HIDDEN = 512       # bf16 cluster recurrences, all four wrappers
# csrc/lstm_wide.cuh's kMaxHidden: its backward keeps 6 H floats in one
# block's shared memory
MAX_HIDDEN = 8192


def hidden_step(dtype):
    """The multiple of H the kernels take: 16 bytes of the type."""
    return 8 if dtype == torch.bfloat16 else 4


def kernel_path(dtype, h_dim):
    """Which kernel each wrapper launches at hidden size ``h_dim`` (per
    direction) in ``dtype``, after padding H to :func:`hidden_step`:
    ``'cluster'`` or ``'wide'``."""
    step = hidden_step(dtype)
    width = -(-h_dim // step) * step
    if dtype == torch.bfloat16 and width <= CLUSTER_HIDDEN:
        return 'cluster'
    return 'wide'


def resize_hidden(x, kind, h_from, h_to):
    """``x`` at hidden size ``h_from`` -> at ``h_to``: zero-padded where
    ``h_to`` is larger, cut where it is smaller (the inverse).

    ``kind`` is ``'units'`` ([..., H]: out, h, c, dout), ``'gates'`` ([...,
    4H]: x_proj, bias, gates, dx, db; each gate block i, j, f, o on its own)
    or ``'u'`` ([H, 4H]: U and dU; rows as units, columns as gates).
    """
    if h_from == h_to:
        return x
    if kind == 'u':
        x = resize_hidden(x, 'gates', h_from, h_to)
        return resize_hidden(x.t(), 'units', h_from, h_to).t()
    if kind == 'gates':
        lead = x.shape[:-1]
        return resize_hidden(x.reshape(*lead, 4, h_from), 'units', h_from,
                             h_to).reshape(*lead, 4 * h_to)
    if h_to > h_from:
        return torch.nn.functional.pad(x, (0, h_to - h_from))
    return x[..., :h_to]


def _fwd_walk(xp, u, b, lens, steps, forget_bias, save_residuals):
    """One direction's masked walk over the time steps ``steps``: ``[out]``,
    or ``[out, gates, hs, cs]`` with ``save_residuals``."""
    t_len, n, four_h = xp.shape
    h_dim = four_h // 4
    rdt = xp.dtype
    lens = lens.to(torch.int64)
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
    return [out, gates, hs, cs] if save_residuals else [out]


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
    t_len = xpf.shape[0]
    return tuple(
        _fwd_walk(xpf, uf, bf, lens, range(t_len), forget_bias,
                  save_residuals)
        + _fwd_walk(xpb, ub, bb, lens, reversed(range(t_len)), forget_bias,
                    save_residuals))


def lstm_fwd_reference(x_proj, u, bias, lens, forget_bias=1.0,
                       save_residuals=False):
    """Plain PyTorch version of ``csrc/lstm_fwd.cu``: the ascending masked
    walk, with the rounding points of :func:`bilstm_fwd_reference`.

    Args:
      x_proj: [T, N, 4H] input projection (bf16 or f32).
      u:      [H, 4H] recurrent weights; bias: [4H]; lens: [N] int32.
    Returns:
      ``out`` [T, N, H] in the input dtype, zero past ``lens``; with
      ``save_residuals`` the TPU kernel's four outputs ``(out, gates, hs,
      cs)``: post-activation gates [T, N, 4H] (i, j, f, o) and the masked h
      and c carries [T, N, H].
    """
    res = _fwd_walk(x_proj, u, bias, lens, range(x_proj.shape[0]),
                    forget_bias, save_residuals)
    return tuple(res) if save_residuals else res[0]


def _pack_u(u, vec):
    """[H, 4H] -> [H/vec, 4H, vec]: the kernel's 16-byte load layout."""
    h_dim, four_h = u.shape
    return u.reshape(h_dim // vec, vec, four_h).transpose(1, 2).contiguous()


def units_per_block(h_dim):
    """Hidden units each block of a bf16 cluster kernel owns (all four
    wrappers of this module): the mma's N of 8 at least, and few enough
    blocks, ``ceil(H / units)``, for one cluster of at most 16:
    ``8 * ceil(H / 128)`` (32 at H = 512, 16 at H = 256, 8 up to H = 128).
    A block runs 16 rows x ``units`` threads."""
    return 8 * -(-h_dim // 128)


def cluster_report(name, h_dim, units):
    """The bf16 cluster of kernel ``name`` (``bilstm_fwd``, ``bilstm_bwd``,
    ``lstm_fwd`` or ``lstm_bwd``) at hidden size ``h_dim``: units a block,
    blocks a cluster, threads a block, dynamic shared memory a block in
    bytes (the kernel's own formula) and how many such clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``; negative: a
    cudaError)."""
    lib = _build.library(name)
    return {'units_per_block': units, 'blocks': -(-h_dim // units),
            'threads': 16 * units,
            'dynamic_smem': getattr(lib, name + '_cluster_smem')(h_dim, units),
            'max_active_clusters': getattr(lib, name + '_max_clusters')(
                h_dim, units)}


def _launch_failed(name, err, h_dim, units=None):
    """The error of a failed launch of ``name``: its cudaError and, for a
    bf16 cluster launch (``units`` given), the cluster's shape and how many
    such clusters the card holds."""
    msg = '{} kernel launch failed: cudaError {}'.format(name, err)
    if units:
        shape = cluster_report(name, h_dim, units)
        msg += (' (bf16 runs one thread-block cluster of {blocks} blocks of '
                '{threads} threads per 16 rows, {dynamic_smem} bytes of shared '
                'memory a block; the card holds {max_active_clusters} such '
                'clusters at once)'.format(**shape))
    return RuntimeError(msg)


def _entry_name(name, dtype, path):
    """The C entry point of kernel ``name`` on ``path``: ``<name>_bf16`` for
    the cluster, ``<name>_wide_bf16`` / ``<name>_wide_f32`` else."""
    suffix = 'bf16' if dtype == torch.bfloat16 else 'f32'
    return name + ('_' if path == 'cluster' else '_wide_') + suffix


def _entry(dtype, path):
    lib = _build.library('bilstm_fwd')
    fn = getattr(lib, _entry_name('bilstm_fwd', dtype, path))
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, p, ctypes.c_longlong] + [p] * 13
                       + [ctypes.c_int] * (4 if path == 'cluster' else 3)
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _check_hidden(name, four_h):
    """H from the gates' width 4H; raises past :data:`MAX_HIDDEN`."""
    if four_h % 4:
        raise ValueError('{}: the gates\' width {} is not 4 H'.format(
            name, four_h))
    h_dim = four_h // 4
    if not 0 < h_dim <= MAX_HIDDEN:
        raise ValueError('{}: hidden size {} unsupported: the kernels take H '
                         'in 1..{} (the wide recurrence keeps 6 H floats in '
                         'one block\'s shared memory)'.format(
                             name, h_dim, MAX_HIDDEN))
    return h_dim


def bilstm_fwd(xpf, xpb, uf, ub, bf, bb, lens, forget_bias=1.0,
               save_residuals=False):
    """Fused masked BiLSTM forward, both directions in one launch.

    Same contract as :func:`bilstm_fwd_reference`. ``xpf``/``xpb`` may be
    column slices of one [T, N, 8H] projection (rows need only share a
    stride). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/bilstm_fwd.cu`` or raise: bf16 up to H = 512 runs the cluster
    recurrence (U in shared memory, tensor-core products), f32 and wider H
    the wide recurrence (:func:`kernel_path`).
    """
    if xpf.device.type == 'cpu':
        return bilstm_fwd_reference(xpf, xpb, uf, ub, bf, bb, lens,
                                    forget_bias, save_residuals)
    if xpf.device.type != 'cuda':
        raise ValueError('bilstm_fwd runs on CUDA or CPU tensors, got {}'
                         .format(xpf.device))
    t_len, n, four_h = xpf.shape
    dtype = xpf.dtype
    if dtype not in _SUPPORTED:
        raise TypeError('bilstm_fwd takes bf16 or f32, got {}'.format(dtype))
    h_dim = _check_hidden('bilstm_fwd', four_h)
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
    vec = hidden_step(dtype)
    width = -(-h_dim // vec) * vec
    if width != h_dim:                  # zero-padded units, results cut back
        res = bilstm_fwd(
            *(resize_hidden(x, 'gates', h_dim, width)
              for x in (xpf, xpb)),
            *(resize_hidden(u, 'u', h_dim, width) for u in (uf, ub)),
            *(resize_hidden(b, 'gates', h_dim, width) for b in (bf, bb)),
            lens, forget_bias, save_residuals)
        kinds = (('units', 'gates', 'units', 'units') * 2 if save_residuals
                 else ('units', 'units'))
        return tuple(resize_hidden(r, k, width, h_dim).contiguous()
                     for r, k in zip(res, kinds))
    row_stride = xpf.stride(1)
    for tns in (xpf, xpb):
        if tns.stride(2) != 1 or tns.stride(0) != n * row_stride \
                or tns.stride(1) != row_stride:
            raise ValueError('xpf/xpb need unit column stride and a shared '
                             'row stride')
    bf, bb, lens = bf.contiguous(), bb.contiguous(), lens.contiguous()
    path = kernel_path(dtype, h_dim)
    if path == 'cluster':   # the kernel gathers its slices of U
        geometry = (units_per_block(h_dim),)
        upf, upb = uf.contiguous(), ub.contiguous()
    else:
        geometry = ()
        upf, upb = _pack_u(uf, vec), _pack_u(ub, vec)

    def new(width):
        return torch.empty(t_len, n, width, dtype=dtype, device=xpf.device)

    of, ob = new(h_dim), new(h_dim)
    gf, hf, cf, gb, hb, cb = (
        [new(four_h), new(h_dim), new(h_dim), new(four_h), new(h_dim),
         new(h_dim)] if save_residuals else [None] * 6)
    if t_len and n:
        ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
        err = _entry(dtype, path)(
            ptr(xpf), ptr(xpb), row_stride, ptr(upf), ptr(upb), ptr(bf),
            ptr(bb), ptr(lens), ptr(of), ptr(ob), ptr(gf), ptr(gb), ptr(hf),
            ptr(hb), ptr(cf), ptr(cb), t_len, n, h_dim, *geometry,
            float(forget_bias),
            torch.cuda.current_stream(xpf.device).cuda_stream)
        if err != 0:
            raise _launch_failed('bilstm_fwd', err, h_dim, *geometry)
        launched(bilstm_fwd)
    if save_residuals:
        return of, gf, hf, cf, ob, gb, hb, cb
    return of, ob


bilstm_fwd.launches = 0


def _bwd_walk(dout, gates, hs, cs, u, lens, fw):
    """One direction's backward walk (the TPU kernel's ``_bi_bwd_step`` /
    ``_bwd_kernel`` step), over the reverse of its forward's order:
    ``(dx, du, db)``."""
    t_len, n, four_h = gates.shape
    h_dim = four_h // 4
    rdt = gates.dtype
    lens = lens.to(torch.int64)
    u32 = u.float()
    dh = torch.zeros(n, h_dim, dtype=torch.float32, device=gates.device)
    dc = torch.zeros_like(dh)
    dx = torch.zeros(t_len, n, four_h, dtype=rdt, device=gates.device)
    du = torch.zeros(h_dim, four_h, dtype=torch.float32, device=gates.device)
    db = torch.zeros(four_h, dtype=torch.float32, device=gates.device)
    for t in (reversed(range(t_len)) if fw else range(t_len)):
        tp = t - 1 if fw else t + 1          # the step's incoming carry
        if 0 <= tp < t_len:
            h_prev, c_prev = hs[tp].float(), cs[tp].float()
        else:
            h_prev, c_prev = torch.zeros_like(dh), torch.zeros_like(dh)
        g = gates[t].float()
        i, j = g[:, :h_dim], g[:, h_dim:2 * h_dim]
        f, o = g[:, 2 * h_dim:3 * h_dim], g[:, 3 * h_dim:]
        tanh_c = torch.tanh(f * c_prev + i * j)
        live = (lens > t).to(torch.float32)[:, None]
        g_hnew = live * (dh + dout[t].float())
        g_cnew = live * dc
        do_ = g_hnew * tanh_c
        dc_tot = g_cnew + g_hnew * o * (1.0 - tanh_c * tanh_c)
        dg = torch.cat([dc_tot * j * i * (1.0 - i),
                        dc_tot * i * (1.0 - j * j),
                        dc_tot * c_prev * f * (1.0 - f),
                        do_ * o * (1.0 - o)], dim=1)
        # dg enters both products rounded to U's dtype; f32 accumulation
        dg_c = dg.to(u.dtype).float()
        dh = dg_c @ u32.t() + (1.0 - live) * dh
        dc = dc_tot * f + (1.0 - live) * dc
        du += h_prev.to(u.dtype).float().t() @ dg_c
        db += dg.sum(dim=0)
        dx[t] = dg.to(rdt)
    return dx, du, db


def bilstm_bwd_reference(dof, dob, gf, hf, cf, gb, hb, cb, uf, ub, lens):
    """Plain PyTorch version of the backward kernel: the TPU kernel's
    ``_bi_bwd_step`` repeated over the reverse of each direction's walk.

    Args:
      dof, dob: [T, N, H] cotangents of the outputs, in the compute dtype.
      gf, hf, cf, gb, hb, cb: the residuals ``bilstm_fwd(save_residuals=
        True)`` returns: gates [T, N, 4H], h and c carries [T, N, H].
      uf, ub:   [H, 4H] recurrent weights; lens: [N] int32.
    Returns:
      ``(dxf, dxb, duf, dbf, dub, dbb)``: dx [T, N, 4H] in the compute
      dtype (the gate pre-activation gradients, which are also the input
      projections' gradients), dU [H, 4H] and db [4H] in f32.
    """
    dxf, duf, dbf = _bwd_walk(dof, gf, hf, cf, uf, lens, fw=True)
    dxb, dub, dbb = _bwd_walk(dob, gb, hb, cb, ub, lens, fw=False)
    return dxf, dxb, duf, dbf, dub, dbb


def lstm_bwd_reference(dout, gates, hs, cs, u, lens):
    """Plain PyTorch version of ``csrc/lstm_bwd.cu``: the one-direction form
    of :func:`bilstm_bwd_reference`, same rounding points.

    Args:
      dout:  [T, N, H] cotangent of the output, in the compute dtype.
      gates, hs, cs: the residuals ``lstm_fwd(save_residuals=True)`` returns.
      u:     [H, 4H] recurrent weights; lens: [N] int32.
    Returns:
      ``(dx, du, db)``: dx [T, N, 4H] in the compute dtype, dU [H, 4H] and
      db [4H] in f32.
    """
    return _bwd_walk(dout, gates, hs, cs, u, lens, fw=True)


def _bwd_entry(dtype, path):
    lib = _build.library('bilstm_bwd')
    fn = getattr(lib, _entry_name('bilstm_bwd', dtype, path))
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 18
                       + [ctypes.c_int] * (4 if path == 'cluster' else 3)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bilstm_bwd(dof, dob, gf, hf, cf, gb, hb, cb, uf, ub, lens):
    """Backward of :func:`bilstm_fwd` from its residuals.

    Same contract as :func:`bilstm_bwd_reference`. CPU tensors run the
    plain version; CUDA tensors launch ``csrc/bilstm_bwd.cu`` (the
    recurrence, the dU product and the db sum, one entry point) or raise:
    bf16 up to H = 512 runs the cluster recurrence of both directions (U in
    shared memory, tensor-core products, dU on tensor cores), f32 and wider
    H the wide recurrence (:func:`kernel_path`).
    """
    if gf.device.type == 'cpu':
        return bilstm_bwd_reference(dof, dob, gf, hf, cf, gb, hb, cb, uf, ub,
                                    lens)
    if gf.device.type != 'cuda':
        raise ValueError('bilstm_bwd runs on CUDA or CPU tensors, got {}'
                         .format(gf.device))
    t_len, n, four_h = gf.shape
    dtype = gf.dtype
    if dtype not in _SUPPORTED:
        raise TypeError('bilstm_bwd takes bf16 or f32, got {}'.format(dtype))
    h_dim = _check_hidden('bilstm_bwd', four_h)
    narrow, wide = (t_len, n, h_dim), (t_len, n, four_h)
    for name, tns, shape in (
            ('dof', dof, narrow), ('dob', dob, narrow), ('gb', gb, wide),
            ('hf', hf, narrow), ('hb', hb, narrow), ('cf', cf, narrow),
            ('cb', cb, narrow), ('uf', uf, (h_dim, four_h)),
            ('ub', ub, (h_dim, four_h))):
        if tns.dtype != dtype or tns.device != gf.device \
                or tuple(tns.shape) != shape:
            raise ValueError('{}: expected {} {} on {}, got {} {} on {}'.format(
                name, shape, dtype, gf.device, tuple(tns.shape), tns.dtype,
                tns.device))
    if lens.dtype != torch.int32 or lens.device != gf.device \
            or tuple(lens.shape) != (n,):
        raise ValueError('lens: expected [{}] int32 on {}'.format(n, gf.device))
    vec = hidden_step(dtype)
    width = -(-h_dim // vec) * vec
    if width != h_dim:                  # zero-padded units, results cut back
        def units(x):
            return resize_hidden(x, 'units', h_dim, width)

        def gates(x):
            return resize_hidden(x, 'gates', h_dim, width)
        res = bilstm_bwd(units(dof), units(dob), gates(gf), units(hf),
                         units(cf), gates(gb), units(hb), units(cb),
                         resize_hidden(uf, 'u', h_dim, width),
                         resize_hidden(ub, 'u', h_dim, width), lens)
        kinds = ('gates', 'gates', 'u', 'gates', 'u', 'gates')
        return tuple(resize_hidden(r, k, width, h_dim).contiguous()
                     for r, k in zip(res, kinds))
    dof, dob, gf, gb, hf, hb, cf, cb, lens = (
        x.contiguous() for x in (dof, dob, gf, gb, hf, hb, cf, cb, lens))
    path = kernel_path(dtype, h_dim)
    if path == 'cluster':   # the kernel gathers its slices of U
        geometry = (units_per_block(h_dim),)
        upf, upb = uf.contiguous(), ub.contiguous()
    else:   # U^T in 16-byte pieces that neighbouring threads read together
        geometry = ()
        upf, upb = _pack_u(uf.t(), vec), _pack_u(ub.t(), vec)
    dev = gf.device
    dxf = torch.empty(wide, dtype=dtype, device=dev)
    dxb = torch.empty(wide, dtype=dtype, device=dev)
    duf, dub = (torch.empty(h_dim, four_h, dtype=torch.float32, device=dev)
                for _ in range(2))
    dbf, dbb = (torch.empty(four_h, dtype=torch.float32, device=dev)
                for _ in range(2))
    if t_len and n:
        db_part = torch.empty(2, n, four_h, dtype=torch.float32, device=dev)
        err = _bwd_entry(dtype, path)(
            *(x.data_ptr() for x in (dof, dob, gf, gb, hf, hb, cf, cb, upf,
                                     upb, lens, dxf, dxb, duf, dub, dbf, dbb,
                                     db_part)),
            t_len, n, h_dim, *geometry,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise _launch_failed('bilstm_bwd', err, h_dim, *geometry)
        launched(bilstm_bwd)
    else:
        for x in (duf, dub, dbf, dbb):
            x.zero_()
    return dxf, dxb, duf, dbf, dub, dbb


bilstm_bwd.launches = 0


# --- the unidirectional scan (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu) ----------------

def _check_lstm(name, x, lens, others):
    """Device, dtype, shape and hidden-size checks shared by ``lstm_fwd`` and
    ``lstm_bwd``; ``x`` is a [T, N, 4H] CUDA tensor, ``others`` a list of
    ``(name, tensor, shape)`` that must match its dtype and device. Returns
    T, N, H, the packing's VEC and H padded to a multiple of it."""
    if x.device.type != 'cuda':
        raise ValueError('{} runs on CUDA or CPU tensors, got {}'.format(
            name, x.device))
    if x.dtype not in _SUPPORTED:
        raise TypeError('{} takes bf16 or f32, got {}'.format(name, x.dtype))
    t_len, n, four_h = x.shape
    h_dim = _check_hidden(name, four_h)
    for oname, tns, shape in others:
        if tns.dtype != x.dtype or tns.device != x.device \
                or tuple(tns.shape) != tuple(shape):
            raise ValueError('{}: expected {} {} on {}, got {} {} on {}'.format(
                oname, tuple(shape), x.dtype, x.device, tuple(tns.shape),
                tns.dtype, tns.device))
    if lens.dtype != torch.int32 or lens.device != x.device \
            or tuple(lens.shape) != (n,):
        raise ValueError('lens: expected [{}] int32 on {}'.format(n, x.device))
    vec = hidden_step(x.dtype)
    return t_len, n, h_dim, vec, -(-h_dim // vec) * vec


def _lstm_entry(name, dtype, path, n_ptr, n_int, tail):
    lib = _build.library(name)
    fn = getattr(lib, _entry_name(name, dtype, path))
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + tail + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def lstm_fwd(x_proj, u, bias, lens, forget_bias=1.0, save_residuals=False):
    """Masked unidirectional LSTM recurrence from the input projection.

    Same contract as :func:`lstm_fwd_reference`. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/lstm_fwd.cu`` or raise: bf16 up to
    H = 512 runs the cluster recurrence (U in shared memory, tensor-core
    products), f32 and wider H the wide recurrence (:func:`kernel_path`)."""
    if x_proj.device.type == 'cpu':
        return lstm_fwd_reference(x_proj, u, bias, lens, forget_bias,
                                  save_residuals)
    four_h = x_proj.shape[2]
    t_len, n, h_dim, vec, width = _check_lstm(
        'lstm_fwd', x_proj, lens,
        [('u', u, (four_h // 4, four_h)), ('bias', bias, (four_h,))])
    if width != h_dim:                  # zero-padded units, results cut back
        res = lstm_fwd(resize_hidden(x_proj, 'gates', h_dim, width),
                       resize_hidden(u, 'u', h_dim, width),
                       resize_hidden(bias, 'gates', h_dim, width), lens,
                       forget_bias, save_residuals)
        if not save_residuals:
            return resize_hidden(res, 'units', width, h_dim).contiguous()
        return tuple(resize_hidden(r, k, width, h_dim).contiguous() for r, k
                     in zip(res, ('units', 'gates', 'units', 'units')))
    dtype, dev = x_proj.dtype, x_proj.device
    x_proj, bias, lens = x_proj.contiguous(), bias.contiguous(), \
        lens.contiguous()
    path = kernel_path(dtype, h_dim)
    if path == 'cluster':    # the kernel gathers its slices of U
        geometry = (units_per_block(h_dim),)
        u_arg = u.contiguous()
    else:
        geometry = ()
        u_arg = _pack_u(u, vec)

    def new(width):
        return torch.empty(t_len, n, width, dtype=dtype, device=dev)

    out = new(h_dim)
    gates, hs, cs = ([new(four_h), new(h_dim), new(h_dim)] if save_residuals
                     else [None] * 3)
    if t_len and n:
        ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
        err = _lstm_entry('lstm_fwd', dtype, path, 8, 3 + len(geometry),
                          [ctypes.c_float])(
            ptr(x_proj), ptr(u_arg), ptr(bias), ptr(lens), ptr(out),
            ptr(gates), ptr(hs), ptr(cs), t_len, n, h_dim, *geometry,
            float(forget_bias), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise _launch_failed('lstm_fwd', err, h_dim, *geometry)
        launched(lstm_fwd)
    return (out, gates, hs, cs) if save_residuals else out


lstm_fwd.launches = 0


def pack_u_slices(u, ub):
    """[H, 4H] -> [CS, H, 4 * ub] with CS = ceil(H / ub): the image that
    block ``b`` of every bf16 cluster kernel copies into shared memory
    straight from U, ``packed[b]``, whose row ``n`` holds U's columns
    ``q * H + b * ub + j`` of its units (gate ``q``, unit ``j``) as
    ``packed[b, n, q * ub + j]``, zero where ``b * ub + j >= H``. No
    wrapper calls it; the tests hold the kernels' copy loops to it."""
    h_dim = u.shape[0]
    cs = -(-h_dim // ub)
    gates = u.reshape(h_dim, 4, h_dim)
    if cs * ub != h_dim:
        gates = torch.nn.functional.pad(gates, (0, cs * ub - h_dim))
    return (gates.reshape(h_dim, 4, cs, ub).permute(2, 0, 1, 3)
            .reshape(cs, h_dim, 4 * ub).contiguous())


def lstm_bwd(dout, gates, hs, cs, u, lens):
    """Backward of :func:`lstm_fwd` from its residuals.

    Same contract as :func:`lstm_bwd_reference`. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/lstm_bwd.cu`` (the recurrence, the
    dU product and the db sum, one entry point) or raise: bf16 up to H = 512
    runs the cluster recurrence with U in shared memory and tensor-core
    products, f32 and wider H the wide recurrence (:func:`kernel_path`)."""
    if gates.device.type == 'cpu':
        return lstm_bwd_reference(dout, gates, hs, cs, u, lens)
    four_h = gates.shape[2]
    narrow = tuple(gates.shape[:2]) + (four_h // 4,)
    t_len, n, h_dim, vec, width = _check_lstm(
        'lstm_bwd', gates, lens,
        [('dout', dout, narrow), ('hs', hs, narrow), ('cs', cs, narrow),
         ('u', u, (four_h // 4, four_h))])
    if width != h_dim:                  # zero-padded units, results cut back
        res = lstm_bwd(*(resize_hidden(x, k, h_dim, width) for x, k in zip(
            (dout, gates, hs, cs, u), ('units', 'gates', 'units', 'units',
                                       'u'))), lens)
        return tuple(resize_hidden(r, k, width, h_dim).contiguous()
                     for r, k in zip(res, ('gates', 'u', 'gates')))
    dtype, dev = gates.dtype, gates.device
    dout, gates, hs, cs, lens = (x.contiguous()
                                 for x in (dout, gates, hs, cs, lens))
    path = kernel_path(dtype, h_dim)
    if path == 'cluster':    # the kernel gathers its slices of U
        geometry = (units_per_block(h_dim),)
        u_arg = u.contiguous()
    else:
        geometry = ()
        u_arg = _pack_u(u.t(), vec)    # U^T in the forward's packing
    dx = torch.empty(t_len, n, four_h, dtype=dtype, device=dev)
    du = torch.empty(h_dim, four_h, dtype=torch.float32, device=dev)
    db = torch.empty(four_h, dtype=torch.float32, device=dev)
    if t_len and n:
        db_part = torch.empty(n, four_h, dtype=torch.float32, device=dev)
        err = _lstm_entry('lstm_bwd', dtype, path, 10, 3 + len(geometry),
                          [])(
            *(x.data_ptr() for x in (dout, gates, hs, cs, u_arg, lens, dx, du,
                                     db, db_part)),
            t_len, n, h_dim, *geometry,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise _launch_failed('lstm_bwd', err, h_dim, *geometry)
        launched(lstm_bwd)
    else:
        du.zero_()
        db.zero_()
    return dx, du, db


lstm_bwd.launches = 0
