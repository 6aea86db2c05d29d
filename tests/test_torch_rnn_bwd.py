"""The port's BiLSTM backward against the JAX package's.

``rnn_cuda.bilstm_bwd_reference`` — the plain version the CUDA kernel
``csrc/bilstm_bwd.cu`` is held to on the card (tests/test_torch_cuda.py) —
is compared with the TPU kernel ``rnn_pallas._bi_bwd_call`` (in Pallas
interpret mode off the TPU, as tests/test_rnn_pallas.py runs it) on the
same residuals, and the gradients of ``ops/rnn.bilstm`` through its
``torch.autograd.Function`` with ``jax.grad`` of ``rnn_pallas.bilstm`` and
of the scan pair. Tolerance: 1e-5 absolute and relative in f32; in bf16, 4
bf16 ulps of each output's largest entry (4 * max|ref| / 256).
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


def _residual_case(seed, t, n, dtype):
    """Forward inputs, the TPU forward's residuals and output cotangents;
    ``t`` is a multiple of the TPU kernel's time block, so neither side
    pads."""
    assert t % rnn_pallas.T_BLK == 0
    rng = np.random.RandomState(seed)

    def mk(*shape, scale=1.0):
        return jnp.asarray((rng.randn(*shape) * scale).astype(np.float32)
                           ).astype(dtype)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1] = 0, t
    fwd = (mk(t, n, 4 * H), mk(t, n, 4 * H), mk(H, 4 * H, scale=0.3),
           mk(H, 4 * H, scale=0.3), mk(4 * H, scale=0.1),
           mk(4 * H, scale=0.1), jnp.asarray(lens))
    _, gf, hf, cf, _, gb, hb, cb = rnn_pallas._bi_fwd_call(*fwd, 1.0)
    dof, dob = mk(t, n, H), mk(t, n, H)
    return (dof, dob, gf, hf, cf, gb, hb, cb, fwd[2], fwd[3], fwd[6])


def _to_torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))
                                ).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize('t,n', [(8, 6), (16, 8)])
def test_reference_matches_tpu_backward_kernel_f32(t, n):
    args = _residual_case(t * n, t, n, jnp.float32)
    want = rnn_pallas._bi_bwd_call(*args, 1.0)      # dxf dxb duf dbf dub dbb
    got = rnn_cuda.bilstm_bwd_reference(*(_to_torch(a) for a in args))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(g.shape)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    # the dispatch takes the plain version for CPU tensors, launching nothing
    again = rnn_cuda.bilstm_bwd(*(_to_torch(a) for a in args))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.numpy(), a.numpy())
    assert rnn_cuda.bilstm_bwd.launches == 0


def test_reference_matches_tpu_backward_kernel_bf16():
    """bf16 residuals: dg enters both products rounded to bf16, sums stay
    f32, dx leaves in bf16 and dU, db in f32, as in ``_bi_bwd_step``."""
    args = _residual_case(7, 8, 8, jnp.bfloat16)
    want = rnn_pallas._bi_bwd_call(*args, 1.0)
    got = rnn_cuda.bilstm_bwd_reference(*(_to_torch(a) for a in args))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (torch.bfloat16 if i < 2 else torch.float32)
        ref = np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        atol = 4 * float(np.abs(ref).max()) / 256.0
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=atol)


def _grad_case(seed, t, n=6):
    rng = np.random.RandomState(seed)
    cells = {name: {'kernel': (rng.randn(D + H, 4 * H) * 0.3
                               ).astype(np.float32),
                    'bias': (rng.randn(4 * H) * 0.1).astype(np.float32)}
             for name in ('fw', 'bw')}
    x = rng.randn(n, t, D).astype(np.float32)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1] = 0, t
    wgt = rng.randn(n, t, 2 * H).astype(np.float32)
    return cells, x, lens, wgt


def _jax_grads(fn, case, dtype=jnp.float32):
    cells, x, lens, wgt = case
    jc = {k: {p: jnp.asarray(v).astype(dtype) for p, v in c.items()}
          for k, c in cells.items()}

    def loss(c, xx):
        out = fn(c, xx, jnp.asarray(lens))
        return jnp.sum(out.astype(jnp.float32) * wgt)
    gc, gx = jax.grad(loss, argnums=(0, 1))(jc, jnp.asarray(x).astype(dtype))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))   # noqa: E731
    out = {'x': f32(gx)}
    for k in ('fw', 'bw'):
        out[k + '.w'] = f32(gc[k]['kernel'])[:D]
        out[k + '.u'] = f32(gc[k]['kernel'])[D:]
        out[k + '.bias'] = f32(gc[k]['bias'])
    return out


def _torch_grads(case, dtype=torch.float32):
    cells, x, lens, wgt = case
    tc = {k: {'w': torch.from_numpy(c['kernel'][:D].copy()).to(dtype),
              'u': torch.from_numpy(c['kernel'][D:].copy()).to(dtype),
              'bias': torch.from_numpy(c['bias'].copy()).to(dtype)}
          for k, c in cells.items()}
    leaves = [torch.from_numpy(x).to(dtype)] + [tc[k][p] for k in ('fw', 'bw')
                                                for p in ('w', 'u', 'bias')]
    for leaf in leaves:
        leaf.requires_grad_()
    out = rnn.bilstm(tc, leaves[0], torch.from_numpy(lens))
    (out.float() * torch.from_numpy(wgt)).sum().backward()
    names = ['x'] + [k + '.' + p for k in ('fw', 'bw')
                     for p in ('w', 'u', 'bias')]
    assert all(leaf.grad.dtype == dtype for leaf in leaves)
    return {n: leaf.grad.float().numpy() for n, leaf in zip(names, leaves)}


@pytest.mark.parametrize('t', [5, 16, 17])
def test_gradients_match_jax_fused_and_scan_pair(t):
    case = _grad_case(t, t)
    got = _torch_grads(case)
    for fn in (rnn_pallas.bilstm, jrnn.bilstm_scan_pair):
        want = _jax_grads(fn, case)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert got['x'][0].any() == False   # noqa: E712  an empty row: no gradient


def test_bf16_gradients_match_jax_fused():
    case = _grad_case(3, 16, n=8)
    got = _torch_grads(case, torch.bfloat16)
    want = _jax_grads(rnn_pallas.bilstm, case, jnp.bfloat16)
    for name in want:
        atol = 4 * float(np.abs(want[name]).max()) / 256.0
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_no_gradient_needed_saves_no_residuals():
    """Without a gradient to compute the forward runs without residuals and
    gives the same output (the eval path is unchanged)."""
    cells, x, lens, _ = _grad_case(9, 7)
    tc = {k: {'w': torch.from_numpy(c['kernel'][:D]),
              'u': torch.from_numpy(c['kernel'][D:]),
              'bias': torch.from_numpy(c['bias'])} for k, c in cells.items()}
    plain = rnn.bilstm(tc, torch.from_numpy(x), torch.from_numpy(lens))
    assert plain.grad_fn is None
    xg = torch.from_numpy(x).requires_grad_()
    tracked = rnn.bilstm(tc, xg, torch.from_numpy(lens))
    assert tracked.grad_fn is not None
    np.testing.assert_array_equal(plain.numpy(), tracked.detach().numpy())
