"""The port's unidirectional LSTM scan against the JAX package's.

The same numpy-seeded inputs go through the JAX Pallas scan
(``rnn_pallas.lstm_scan``, in interpret mode off the TPU, as
tests/test_rnn_pallas.py runs it), the JAX ``lax.scan`` version
(``ops/rnn.lstm_scan``), the port's plain twins of the CUDA kernels
(``rnn_cuda.lstm_fwd_reference`` / ``lstm_bwd_reference``) and the port's
dispatch (``ops/rnn.lstm``, which takes the plain versions for CPU tensors).
Outputs, the residual contract (gates, h, c), the backward from the TPU
forward's residuals, and the gradients of kernel, bias and x through the
``torch.autograd.Function``. Tolerance: 1e-5 absolute and relative in f32;
in bf16, 4 bf16 ulps of each tensor's largest entry (4 * max|ref| / 256).

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py (skipped without a GPU) and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.ops import rnn as jrnn
from lstm_ctc_ocr_tpu.ops import rnn_pallas
from lstm_ctc_ocr_torch.ops import rnn, rnn_cuda

D, H = 12, 8


def _case(seed, t, n=6):
    rng = np.random.RandomState(seed)
    cell = {'kernel': (rng.randn(D + H, 4 * H) * 0.3).astype(np.float32),
            'bias': (rng.randn(4 * H) * 0.1).astype(np.float32)}
    x = rng.randn(t, n, D).astype(np.float32)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1], lens[2] = 1, t, 0     # one frame, full, and empty rows
    wgt = rng.randn(t, n, H).astype(np.float32)
    return cell, x, lens, wgt


def _jax_cell(cell, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in cell.items()}


def _torch_cell(cell, dtype=torch.float32):
    return {'w': torch.from_numpy(cell['kernel'][:D].copy()).to(dtype),
            'u': torch.from_numpy(cell['kernel'][D:].copy()).to(dtype),
            'bias': torch.from_numpy(cell['bias'].copy()).to(dtype)}


def _bf16_atol(ref):
    return 4 * max(float(np.abs(ref).max()), 1e-6) / 256.0


def _to_torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))
                                ).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize('t', [5, 16, 17])
def test_lstm_matches_jax_pallas_and_scan(t):
    cell, x, lens, _ = _case(t, t)
    jargs = (_jax_cell(cell), jnp.asarray(x), jnp.asarray(lens))
    want_pallas = np.asarray(rnn_pallas.lstm_scan(*jargs))
    want_scan = np.asarray(jrnn.lstm_scan(*jargs))
    targs = (_torch_cell(cell), torch.from_numpy(x), torch.from_numpy(lens))
    ported = rnn.lstm(*targs).numpy()
    plain = rnn.lstm_scan(*targs).numpy()
    for got in (ported, plain):
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_scan, rtol=1e-5, atol=1e-5)
    assert np.all(ported[np.arange(t)[:, None] >= lens[None, :]] == 0.0)
    assert rnn_cuda.lstm_fwd.launches == 0      # CPU tensors launch nothing


@pytest.mark.parametrize('t', [5, 16, 17])
def test_reference_residuals_match_tpu_kernel(t):
    """save_residuals: out, gates, h and c trajectories as ``_fwd_call``
    returns them (time padded to its block of 8 on both sides)."""
    cell, x, lens, _ = _case(100 + t, t)
    n = x.shape[1]
    t_pad = -(-t // rnn_pallas.T_BLK) * rnn_pallas.T_BLK
    xp = np.zeros((t_pad, n, 4 * H), np.float32)
    xp[:t] = np.random.RandomState(t).randn(t, n, 4 * H)
    args = (xp, cell['kernel'][D:], cell['bias'], lens)
    want = rnn_pallas._fwd_call(*(jnp.asarray(a) for a in args), 1.0)
    got = rnn_cuda.lstm_fwd_reference(*(torch.from_numpy(a) for a in args),
                                      1.0, save_residuals=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    out = rnn_cuda.lstm_fwd(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(out.numpy(), got[0].numpy())


def _residual_case(seed, t, n, dtype):
    """The TPU forward's residuals and an output cotangent; ``t`` is a
    multiple of the TPU kernel's time block, so neither side pads."""
    assert t % rnn_pallas.T_BLK == 0
    rng = np.random.RandomState(seed)

    def mk(*shape, scale=1.0):
        return jnp.asarray((rng.randn(*shape) * scale).astype(np.float32)
                           ).astype(dtype)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1], lens[2] = 1, t, 0
    fwd = (mk(t, n, 4 * H), mk(H, 4 * H, scale=0.3), mk(4 * H, scale=0.1),
           jnp.asarray(lens))
    _, gates, hs, cs = rnn_pallas._fwd_call(*fwd, 1.0)
    return (mk(t, n, H), gates, hs, cs, fwd[1], fwd[3])


@pytest.mark.parametrize('t,n', [(8, 6), (16, 8)])
def test_reference_matches_tpu_backward_kernel_f32(t, n):
    args = _residual_case(t * n, t, n, jnp.float32)
    want = rnn_pallas._bwd_call(*args)                      # dx, du, db
    got = rnn_cuda.lstm_bwd_reference(*(_to_torch(a) for a in args))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   rtol=1e-5, atol=1e-5)
    again = rnn_cuda.lstm_bwd(*(_to_torch(a) for a in args))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.numpy(), a.numpy())
    assert rnn_cuda.lstm_bwd.launches == 0


def test_reference_matches_tpu_kernels_bf16():
    """bf16: h and dg enter the products rounded to bf16, sums stay f32,
    residuals and dx leave in bf16 and dU, db in f32, as in ``_fwd_kernel``
    and ``_bwd_kernel``."""
    rng = np.random.RandomState(3)
    t, n = 16, 8
    fwd = [jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16) for a in (
        rng.randn(t, n, 4 * H), rng.randn(H, 4 * H) * 0.3,
        rng.randn(4 * H) * 0.1)]
    lens = np.array([1, t, 0, 5, 9, 16, 3, 12], np.int32)
    want = rnn_pallas._fwd_call(*fwd, jnp.asarray(lens), 1.0)
    got = rnn_cuda.lstm_fwd_reference(*(_to_torch(a) for a in fwd),
                                      torch.from_numpy(lens), 1.0,
                                      save_residuals=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        ref = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0,
                                   atol=_bf16_atol(ref))
    args = _residual_case(7, 8, 8, jnp.bfloat16)
    want = rnn_pallas._bwd_call(*args)
    got = rnn_cuda.lstm_bwd_reference(*(_to_torch(a) for a in args))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (torch.bfloat16 if i == 0 else torch.float32)
        ref = np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0,
                                   atol=_bf16_atol(ref))


def _jax_grads(fn, case, dtype=jnp.float32):
    cell, x, lens, wgt = case

    def loss(c, xx):
        out = fn(c, xx, jnp.asarray(lens))
        return jnp.sum(out.astype(jnp.float32) * wgt)
    gc, gx = jax.grad(loss, argnums=(0, 1))(_jax_cell(cell, dtype),
                                            jnp.asarray(x).astype(dtype))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))   # noqa: E731
    return {'x': f32(gx), 'w': f32(gc['kernel'])[:D],
            'u': f32(gc['kernel'])[D:], 'bias': f32(gc['bias'])}


def _torch_grads(case, dtype=torch.float32):
    cell, x, lens, wgt = case
    tc = _torch_cell(cell, dtype)
    leaves = {'x': torch.from_numpy(x).to(dtype), **tc}
    for leaf in leaves.values():
        leaf.requires_grad_()
    out = rnn.lstm(tc, leaves['x'], torch.from_numpy(lens))
    (out.float() * torch.from_numpy(wgt)).sum().backward()
    assert all(leaf.grad.dtype == dtype for leaf in leaves.values())
    return {k: leaf.grad.float().numpy() for k, leaf in leaves.items()}


@pytest.mark.parametrize('t', [5, 16, 17])
def test_gradients_match_jax_pallas_and_scan(t):
    case = _case(t, t)
    got = _torch_grads(case)
    for fn in (rnn_pallas.lstm_scan, jrnn.lstm_scan):
        want = _jax_grads(fn, case)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert not got['x'][:, 2].any()             # an empty row: no gradient
    assert not got['x'][1:, 0].any()            # past a one-frame row's end


def test_bf16_output_and_gradients_match_jax_pallas():
    case = _case(3, 16, n=8)
    cell, x, lens, _ = case
    want_out = np.asarray(rnn_pallas.lstm_scan(
        _jax_cell(cell, jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(lens)).astype(jnp.float32))
    out = rnn.lstm(_torch_cell(cell, torch.bfloat16),
                   torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(lens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want_out, rtol=0,
                               atol=_bf16_atol(want_out))
    got = _torch_grads(case, torch.bfloat16)
    want = _jax_grads(rnn_pallas.lstm_scan, case, jnp.bfloat16)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=_bf16_atol(want[name]), err_msg=name)


@pytest.mark.parametrize('t', [5, 17])
def test_scan_pair_over_the_kernel_scan_matches_jax_pair(t):
    """``bilstm_scan_pair(scan=rnn.lstm)``: the pair on kernels 5/6, as the
    JAX pair runs on ``select_scan()``; output and gradients."""
    rng = np.random.RandomState(t)
    cells = {k: {'kernel': (rng.randn(D + H, 4 * H) * 0.3).astype(np.float32),
                 'bias': (rng.randn(4 * H) * 0.1).astype(np.float32)}
             for k in ('fw', 'bw')}
    n = 6
    x = rng.randn(n, t, D).astype(np.float32)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1] = 1, t
    wgt = rng.randn(n, t, 2 * H).astype(np.float32)

    def jloss(c, xx):
        return jnp.sum(jrnn.bilstm_scan_pair(c, xx, jnp.asarray(lens)) * wgt)
    jc = {k: _jax_cell(c) for k, c in cells.items()}
    want = np.asarray(jrnn.bilstm_scan_pair(jc, jnp.asarray(x),
                                            jnp.asarray(lens)))
    gc, gx = jax.grad(jloss, argnums=(0, 1))(jc, jnp.asarray(x))

    tc = {k: _torch_cell(c) for k, c in cells.items()}
    xt = torch.from_numpy(x).requires_grad_()
    for cell in tc.values():
        for leaf in cell.values():
            leaf.requires_grad_()
    got = rnn.bilstm_scan_pair(tc, xt, torch.from_numpy(lens), scan=rnn.lstm)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    default = rnn.bilstm_scan_pair(tc, xt, torch.from_numpy(lens))
    np.testing.assert_allclose(default.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    (got * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
    for k in ('fw', 'bw'):
        kernel = np.asarray(gc[k]['kernel'])
        for name, ref in (('w', kernel[:D]), ('u', kernel[D:]),
                          ('bias', np.asarray(gc[k]['bias']))):
            np.testing.assert_allclose(tc[k][name].grad.numpy(), ref,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=k + '.' + name)


def test_no_gradient_needed_saves_no_residuals():
    """Without a gradient to compute the forward runs without residuals and
    gives the same output (the eval path)."""
    cell, x, lens, _ = _case(9, 7)
    tc = _torch_cell(cell)
    plain = rnn.lstm(tc, torch.from_numpy(x), torch.from_numpy(lens))
    assert plain.grad_fn is None
    xg = torch.from_numpy(x).requires_grad_()
    tracked = rnn.lstm(tc, xg, torch.from_numpy(lens))
    assert tracked.grad_fn is not None
    np.testing.assert_array_equal(plain.numpy(), tracked.detach().numpy())


@pytest.mark.parametrize('h,ub,cs', [(8, 8, 1), (24, 8, 3), (136, 16, 9),
                                     (256, 16, 16), (264, 24, 11),
                                     (512, 32, 16)])
def test_pack_u_slices_matches_index_formula(h, ub, cs):
    """``lstm_bwd``'s bf16 packing of U: block ``b`` of the cluster gets
    ``packed[b, n, q * ub + j] = U[n, q * H + b * ub + j]`` (zero past H),
    with ``ub = units_per_block(H)`` a multiple of 8 and at most 16 blocks."""
    assert rnn_cuda.units_per_block(h) == ub
    u = np.random.RandomState(h).randn(h, 4 * h).astype(np.float32)
    packed = rnn_cuda.pack_u_slices(torch.from_numpy(u), ub)
    assert packed.shape == (cs, h, 4 * ub) and packed.is_contiguous()
    got = packed.numpy()
    for b in range(cs):
        for q in range(4):
            for j in range(ub):
                unit = b * ub + j
                want = u[:, q * h + unit] if unit < h else np.zeros(h)
                np.testing.assert_array_equal(got[b, :, q * ub + j], want)
