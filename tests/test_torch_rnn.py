"""The port's BiLSTM against the JAX package's.

The same numpy-seeded inputs go through the JAX fused kernel
(``rnn_pallas.bilstm``, in Pallas interpret mode off the TPU, as
tests/test_rnn_pallas.py runs it), the JAX scan pair, the port's plain twin of
the CUDA kernel (``rnn_cuda.bilstm_fwd_reference``) and the port's dispatch
(``ops/rnn.bilstm``, which takes the plain version for CPU tensors).
Tolerance: 1e-5 absolute and relative in f32, the repo's standing bar.

The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py (skipped without a GPU) and by chip_smoke.py's
kernel phase.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_ctc_ocr_tpu.ops import rnn as jrnn
from lstm_ctc_ocr_tpu.ops import rnn_pallas
from lstm_ctc_ocr_torch.ops import rnn, rnn_cuda

D, H = 12, 8


def _case(seed, t, n=6):
    rng = np.random.RandomState(seed)
    cells = {}
    for name in ('fw', 'bw'):
        cells[name] = {
            'kernel': (rng.randn(D + H, 4 * H) * 0.3).astype(np.float32),
            'bias': (rng.randn(4 * H) * 0.1).astype(np.float32)}
    x = rng.randn(n, t, D).astype(np.float32)
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1] = 0, t                   # an empty row and a full row
    return cells, x, lens


def _jax_cells(cells):
    return {k: {p: jnp.asarray(v) for p, v in c.items()}
            for k, c in cells.items()}


def _torch_cells(cells):
    return {k: {'w': torch.from_numpy(c['kernel'][:D]),
                'u': torch.from_numpy(c['kernel'][D:]),
                'bias': torch.from_numpy(c['bias'])}
            for k, c in cells.items()}


@pytest.mark.parametrize('t', [5, 16, 17])
def test_bilstm_matches_jax_fused_and_scan_pair(t):
    cells, x, lens = _case(t, t)
    jfused = np.asarray(rnn_pallas.bilstm(_jax_cells(cells), jnp.asarray(x),
                                          jnp.asarray(lens)))
    jpair = np.asarray(jrnn.bilstm_scan_pair(_jax_cells(cells),
                                             jnp.asarray(x), jnp.asarray(lens)))
    tc = _torch_cells(cells)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    ported = rnn.bilstm(tc, xt, lt).numpy()
    pair = rnn.bilstm_scan_pair(tc, xt, lt).numpy()
    for got in (ported, pair):
        np.testing.assert_allclose(got, jfused, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jpair, rtol=1e-5, atol=1e-5)
    assert np.all(ported[np.arange(t)[None, :] >= lens[:, None]] == 0.0)


@pytest.mark.parametrize('t', [5, 16, 17])
def test_reference_residuals_match_tpu_kernel(t):
    """save_residuals: gates, h and c trajectories as ``_bi_fwd_call``
    returns them (time padded to its block of 8 on both sides)."""
    cells, x, lens = _case(100 + t, t)
    t_pad = -(-t // rnn_pallas.T_BLK) * rnn_pallas.T_BLK
    rng = np.random.RandomState(t)
    xpf = np.zeros((t_pad, x.shape[0], 4 * H), np.float32)
    xpb = np.zeros_like(xpf)
    xpf[:t] = rng.randn(t, x.shape[0], 4 * H)
    xpb[:t] = rng.randn(t, x.shape[0], 4 * H)
    args = (xpf, xpb, cells['fw']['kernel'][D:], cells['bw']['kernel'][D:],
            cells['fw']['bias'], cells['bw']['bias'], lens)
    want = rnn_pallas._bi_fwd_call(*(jnp.asarray(a) for a in args), 1.0)
    got = rnn_cuda.bilstm_fwd_reference(
        *(torch.from_numpy(a) for a in args), 1.0, save_residuals=True)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    of, ob = rnn_cuda.bilstm_fwd(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(of.numpy(), got[0].numpy())
    np.testing.assert_array_equal(ob.numpy(), got[4].numpy())


def test_lstm_scan_and_reverse_sequence_match_jax():
    cells, x, lens = _case(7, 9)
    x_tm = np.swapaxes(x, 0, 1).copy()
    want = np.asarray(jrnn.lstm_scan(_jax_cells(cells)['fw'],
                                     jnp.asarray(x_tm), jnp.asarray(lens)))
    got = rnn.lstm_scan(_torch_cells(cells)['fw'], torch.from_numpy(x_tm),
                        torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rev = rnn.reverse_sequence(torch.from_numpy(x_tm),
                               torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(
        rev, np.asarray(jrnn.reverse_sequence(jnp.asarray(x_tm),
                                              jnp.asarray(lens))))


def test_bf16_reference_rounds_h_like_tpu_kernel():
    """bf16 inputs: h enters the recurrent product rounded to bf16 and the
    product accumulates in f32, as in the TPU kernel (``_bi_cell``)."""
    cells, x, lens = _case(3, 16, n=8)
    rng = np.random.RandomState(3)
    xpf = rng.randn(16, 8, 4 * H).astype(np.float32)
    xpb = rng.randn(16, 8, 4 * H).astype(np.float32)
    args = [xpf, xpb, cells['fw']['kernel'][D:], cells['bw']['kernel'][D:],
            cells['fw']['bias'], cells['bw']['bias']]
    want = rnn_pallas._bi_fwd_call(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in args),
        jnp.asarray(lens), 1.0)
    got = rnn_cuda.bilstm_fwd_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in args),
        torch.from_numpy(lens), 1.0, save_residuals=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        ref = np.asarray(w.astype(jnp.float32))
        atol = 4 * max(float(np.abs(ref).max()), 1.0) / 256.0   # 4 bf16 ulps
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=atol)
