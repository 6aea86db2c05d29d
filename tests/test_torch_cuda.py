"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on the GPU machine without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file, tests/test_torch_beam_cuda.py and tests/test_torch_htr_cuda.py
hold the kernels' cases on the card, edge cases among them (ragged and
partial batches, every width, the CTC kernels' path boundaries and long
labels); ``chip_smoke.py`` holds each kernel at the main path's shapes at
these bars and times it there. A new edge case is one more tuple in the
test that checks the same property.

Tolerances: f32 max |difference| <= 1e-4 (the kernel and the plain version
sum the recurrent product in different orders); bf16 <= 4 bf16 ulps of each
output's magnitude, 4 * max|ref| / 256, as tests/test_rnn_pallas.py
defines it. The BiLSTM backward's f32 bar is 1e-4 relative to each
output's largest entry (dU sums T*N products). CTC: the forward
bit-identical to its plain version, the gradient within 1e-5 of it (f32
throughout, same operation order). The unidirectional LSTM kernels carry
the BiLSTM kernels' bars at H = 512 and at every width. The fused
conv3x3+BN+ReLU kernel: 2e-5 absolute and relative in f32, 2e-2 in bf16
(the bars of tests/test_conv_bn_pallas.py), against its plain version and
the unfused layer, and two runs bit-identical, as for the LSTM kernels at
the edges of their bf16 cluster tiling. Two tests train from the synthetic
stream, with worker processes forked after CUDA has started, and count the
kernels' launches; the last exports a decode program (``engine/serve.py``)
and counts kernel 1's launch in it.
"""

import os

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.ops import conv_bn_cuda, ctc, ctc_cuda, rnn, rnn_cuda
from lstm_ctc_ocr_torch.tools import bench_conv_bn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _atol(ref, dtype):
    if dtype == torch.float32:
        return 1e-4
    return 4 * (float(ref.abs().max()) or 1.0) / 256.0


# every hidden width a direction the JAX package runs off the main path's:
# no multiple of 8 (zero-padded), the bf16 cluster's limit of 512 and past
# it the wide recurrence; at the eval buckets' T = 23 and 111 with batch 64,
# a ragged batch of 37 and T = 1. test_kernels_take_every_width is their one
# home; the edge tests below take the main path's widths and the tiling's
WIDTH_CASES = [(t, n, h) for h in (50, 300, 512, 768, 1024)
               for t, n in ((23, 64), (111, 64), (23, 37), (1, 3))]
# the htr_puigcerver.train_graphed cell's layer: batch 16 at T = 224, H = 256;
# its rows run their own 137-222 frames and its forget bias is 0
HTR = (224, 16, 256)
# its CTC case, (T, L, N, C, frames): labels of 22-24 of 80 classes, each
# line's own 137-222 frames
HTR_CTC = (224, 24, 16, 80, (137, 222))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n', [(23, 64), (7, 37)])
def test_bilstm_kernel_matches_reference(cuda_device, dtype, t, n):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(t * n)
    h = 256

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens = rng.randint(0, t + 1, n).astype(np.int32)
    lens[0] = 0
    args = (mk(t, n, 4 * h), mk(t, n, 4 * h), mk(h, 4 * h, scale=h ** -0.5),
            mk(h, 4 * h, scale=h ** -0.5), mk(4 * h, scale=0.1),
            mk(4 * h, scale=0.1), torch.from_numpy(lens).to(cuda_device))
    for residuals in (False, True):
        before = rnn_cuda.bilstm_fwd.launches
        got = rnn_cuda.bilstm_fwd(*args, save_residuals=residuals)
        assert rnn_cuda.bilstm_fwd.launches == before + 1
        want = rnn_cuda.bilstm_fwd_reference(*args, save_residuals=residuals)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (8 if residuals else 2)
        for g, w in zip(got, want):
            assert g.dtype == dt and g.shape == w.shape
            w = w.float()
            assert float((g.float() - w).abs().max()) <= _atol(w, dt)


def _ragged_lens(t, n, dev):
    """Lengths that die at different t inside one 16-row group, with a row
    of length 0 and a full row."""
    lens = (np.arange(n) * 5) % (t + 1)
    lens[0], lens[-1] = 0, t
    return torch.from_numpy(lens.astype(np.int32)).to(dev)


def _bilstm_lens(t, n, h, dev):
    """A BiLSTM case's lengths and forget bias: at :data:`HTR` the cell's
    own (137-222 frames, forget bias 0), else :func:`_ragged_lens` and 1."""
    if (t, n, h) == HTR:
        lens = np.linspace(137, 222, n).astype(np.int32)
        return torch.from_numpy(lens).to(dev), 0.0
    return _ragged_lens(t, n, dev), 1.0


def _check_fwd(got, again, want, dt, lens, outputs):
    """A forward's results within the bar of the plain version, a second
    call bit-identical, and the ``outputs`` (indices) zero at dead steps."""
    assert len(got) == len(want) == len(again)
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert g.dtype == dt and g.shape == w.shape, i
        assert torch.equal(g, a), i
        w = w.float()
        assert float((g.float() - w).abs().max()) <= _atol(w, dt), i
    dead = torch.arange(got[0].shape[0], device=lens.device)[:, None] \
        >= lens[None, :]
    for i in outputs:
        assert not got[i][dead].any(), i


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n,h', [
    (23, 64, 256), (111, 64, 256), (7, 37, 256), (1, 3, 256), (5, 20, 136),
    (3, 4, 8), (23, 37, 256), HTR])
def test_bilstm_fwd_cluster_edges_and_determinism(cuda_device, dtype, t, n,
                                                  h):
    """``bilstm_fwd`` at the edges of the bf16 cluster tiling (f32 runs the
    wide recurrence on the same cases): the eval buckets' T = 23
    and 111 at batch 64, rows dying inside a 16-row group and a row of
    length 0, T = 1, a partial last row group, H = 136 (the last block owns
    fewer units) and H = 8 (one block); the handwriting cell's layer
    (:data:`HTR`); residuals off and on, each called twice:
    bit-identical."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3 * t + n + h)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens, fb = _bilstm_lens(t, n, h, cuda_device)
    xp = mk(t, n, 8 * h)           # both projections as slices of one
    args = (xp[:, :, :4 * h], xp[:, :, 4 * h:], mk(h, 4 * h, scale=h ** -0.5),
            mk(h, 4 * h, scale=h ** -0.5), mk(4 * h, scale=0.1),
            mk(4 * h, scale=0.1), lens, fb)
    for residuals in (False, True):
        before = rnn_cuda.bilstm_fwd.launches
        got = rnn_cuda.bilstm_fwd(*args, save_residuals=residuals)
        again = rnn_cuda.bilstm_fwd(*args, save_residuals=residuals)
        assert rnn_cuda.bilstm_fwd.launches == before + 2
        want = rnn_cuda.bilstm_fwd_reference(*args,
                                             save_residuals=residuals)
        torch.cuda.synchronize()
        _check_fwd(got, again, want, dt, lens, (0, 4) if residuals
                   else (0, 1))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n,h', [
    (23, 64, 512), (111, 64, 512), (7, 37, 512), (1, 3, 256), (6, 20, 136),
    (11, 1, 8), (23, 37, 512), (11, 5, 8)])
def test_lstm_fwd_cluster_edges_and_determinism(cuda_device, dtype, t, n, h):
    """``lstm_fwd`` at the edges of the bf16 cluster tiling (f32 runs the
    wide recurrence on the same cases): the stacked head's H = 512
    at T = 23 and 111, rows dying inside a 16-row group and a row of length
    0, T = 1, N = 1, 3 and 5 (a partial row group), H = 136 (the last block
    owns fewer units than the others, U's columns zero-filled past H) and
    H = 8 (a cluster of one block); residuals off and on, each called
    twice: bit-identical."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(5 * t + n + h)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens = _ragged_lens(t, n, cuda_device)
    args = (mk(t, n, 4 * h), mk(h, 4 * h, scale=h ** -0.5),
            mk(4 * h, scale=0.1), lens)
    for residuals in (False, True):
        before = rnn_cuda.lstm_fwd.launches
        got = rnn_cuda.lstm_fwd(*args, save_residuals=residuals)
        again = rnn_cuda.lstm_fwd(*args, save_residuals=residuals)
        assert rnn_cuda.lstm_fwd.launches == before + 2
        want = rnn_cuda.lstm_fwd_reference(*args, save_residuals=residuals)
        torch.cuda.synchronize()
        if not residuals:
            got, again, want = (got,), (again,), (want,)
        _check_fwd(got, again, want, dt, lens, (0,))


def test_cluster_reports(cuda_device):
    """Each bf16 cluster kernel reports its shape at the main path's widths,
    at least one such cluster fits the card, and a failed launch's error
    names the shape."""
    for name, h in (('bilstm_fwd', 256), ('bilstm_bwd', 256),
                    ('lstm_fwd', 512), ('lstm_bwd', 512)):
        units = rnn_cuda.units_per_block(h)
        rep = rnn_cuda.cluster_report(name, h, units)
        assert rep['blocks'] == 16 and rep['threads'] == 16 * units
        assert 0 < rep['dynamic_smem'] <= 232448
        assert rep['max_active_clusters'] > 0, rep
        err = rnn_cuda._launch_failed(name, 9, h, units)
        assert 'cudaError 9' in str(err) and '16 blocks' in str(err)


def test_bilstm_dispatch_launches_kernel(cuda_device):
    """``ops/rnn.bilstm`` on CUDA tensors goes through the kernel once and
    agrees with the same call on CPU tensors (the plain version) in f32."""
    g = torch.Generator().manual_seed(0)
    d, h, n, t = 32, 16, 5, 9
    cells = {k: {'w': torch.randn(d, 4 * h, generator=g) * 0.3,
                 'u': torch.randn(h, 4 * h, generator=g) * 0.3,
                 'bias': torch.randn(4 * h, generator=g) * 0.1}
             for k in ('fw', 'bw')}
    x = torch.randn(n, t, d, generator=g)
    lens = torch.tensor([9, 0, 4, 1, 7], dtype=torch.int32)
    want = rnn.bilstm(cells, x, lens)
    before = rnn_cuda.bilstm_fwd.launches
    got = rnn.bilstm({k: {p: v.to(cuda_device) for p, v in c.items()}
                      for k, c in cells.items()},
                     x.to(cuda_device), lens.to(cuda_device))
    assert rnn_cuda.bilstm_fwd.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_bilstm_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(3, 2, 4 * 512, device=cuda_device)
    u = torch.zeros(512, 4 * 512, device=cuda_device)
    b = torch.zeros(4 * 512, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    # past the wide recurrence's shared memory; the width is checked first
    past = torch.zeros(1, 2, 4 * (rnn_cuda.MAX_HIDDEN + 8),
                       device=cuda_device)
    with pytest.raises(ValueError, match='hidden size'):
        rnn_cuda.bilstm_fwd(past, past, u, u, b, b, lens)
    with pytest.raises(ValueError, match='lens'):
        rnn_cuda.bilstm_fwd(x[..., :1024], x[..., :1024], u[:256, :1024],
                            u[:256, :1024], b[:1024], b[:1024], lens.long())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n', [(23, 64), (7, 37), (1, 3)])
def test_bilstm_bwd_kernel_matches_reference(cuda_device, dtype, t, n):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(1000 + t * n)
    h = 256

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens = rng.randint(0, t + 1, n).astype(np.int32)
    lens[0], lens[1] = 0, t
    lens = torch.from_numpy(lens).to(cuda_device)
    uf, ub = mk(h, 4 * h, scale=h ** -0.5), mk(h, 4 * h, scale=h ** -0.5)
    _, gf, hf, cf, _, gb, hb, cb = rnn_cuda.bilstm_fwd(
        mk(t, n, 4 * h), mk(t, n, 4 * h), uf, ub, mk(4 * h, scale=0.1),
        mk(4 * h, scale=0.1), lens, save_residuals=True)
    args = (mk(t, n, h), mk(t, n, h), gf, hf, cf, gb, hb, cb, uf, ub, lens)
    before = rnn_cuda.bilstm_bwd.launches
    got = rnn_cuda.bilstm_bwd(*args)
    assert rnn_cuda.bilstm_bwd.launches == before + 1
    want = rnn_cuda.bilstm_bwd_reference(*args)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == (dt if i < 2 else torch.float32)
        assert g.shape == w.shape
        w = w.float()
        scale = max(float(w.abs().max()), 1e-6)
        tol = 1e-4 * scale if dt == torch.float32 else 4 * scale / 256.0
        assert float((g.float() - w).abs().max()) <= tol, i


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n,h', [
    (23, 37, 256), (111, 64, 256), (1, 5, 256), (11, 1, 8), (6, 20, 136),
    (4, 17, 200), (23, 64, 256), (7, 37, 256), (1, 3, 256), HTR])
def test_bilstm_bwd_cluster_edges_and_determinism(cuda_device, dtype, t, n,
                                                  h):
    """``bilstm_bwd`` at the edges of the bf16 cluster tiling, both
    directions: rows that die at different t inside one 16-row group and a
    row of length 0; T = 1 (both directions' carries are zero); a partial
    last row group (N = 37, 5, 3, 1, 20, 17); H from one block of 8 units
    to 16 blocks of 16, and H = 136 and 200, whose last cluster block owns
    fewer units than the others; the handwriting cell's layer
    (:data:`HTR`). Two calls are bit-identical, and dead steps give
    dx = 0."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3 * t + n + h)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens, fb = _bilstm_lens(t, n, h, cuda_device)
    uf, ub = mk(h, 4 * h, scale=h ** -0.5), mk(h, 4 * h, scale=h ** -0.5)
    _, gf, hf, cf, _, gb, hb, cb = rnn_cuda.bilstm_fwd(
        mk(t, n, 4 * h), mk(t, n, 4 * h), uf, ub, mk(4 * h, scale=0.1),
        mk(4 * h, scale=0.1), lens, fb, save_residuals=True)
    args = (mk(t, n, h), mk(t, n, h), gf, hf, cf, gb, hb, cb, uf, ub, lens)
    before = rnn_cuda.bilstm_bwd.launches
    got = rnn_cuda.bilstm_bwd(*args)
    again = rnn_cuda.bilstm_bwd(*args)
    assert rnn_cuda.bilstm_bwd.launches == before + 2
    want = rnn_cuda.bilstm_bwd_reference(*args)
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a) and g.shape == w.shape, i
        w = w.float()
        scale = max(float(w.abs().max()), 1e-6)
        tol = 1e-4 * scale if dt == torch.float32 else 4 * scale / 256.0
        assert float((g.float() - w).abs().max()) <= tol, i
    dead = torch.arange(t, device=cuda_device)[:, None] >= lens[None, :]
    assert not got[0][dead].any() and not got[1][dead].any()


def test_bilstm_gradients_through_kernels(cuda_device):
    """``ops/rnn.bilstm`` under autograd on CUDA tensors: one forward and one
    backward launch, gradients equal to the CPU (plain) ones in f32."""
    gen = torch.Generator().manual_seed(1)
    d, h, n, t = 32, 16, 5, 9
    cells = {k: {'w': torch.randn(d, 4 * h, generator=gen) * 0.3,
                 'u': torch.randn(h, 4 * h, generator=gen) * 0.3,
                 'bias': torch.randn(4 * h, generator=gen) * 0.1}
             for k in ('fw', 'bw')}
    x = torch.randn(n, t, d, generator=gen)
    wgt = torch.randn(n, t, 2 * h, generator=gen)
    lens = torch.tensor([9, 0, 4, 1, 7], dtype=torch.int32)

    def grads(dev):
        c = {k: {p: v.clone().to(dev).requires_grad_() for p, v in cell.items()}
             for k, cell in cells.items()}
        xd = x.clone().to(dev).requires_grad_()
        (rnn.bilstm(c, xd, lens.to(dev)) * wgt.to(dev)).sum().backward()
        return [xd.grad.cpu()] + [c[k][p].grad.cpu() for k in ('fw', 'bw')
                                  for p in ('w', 'u', 'bias')]
    want = grads('cpu')
    fwd0, bwd0 = rnn_cuda.bilstm_fwd.launches, rnn_cuda.bilstm_bwd.launches
    got = grads(cuda_device)
    assert rnn_cuda.bilstm_fwd.launches == fwd0 + 1
    assert rnn_cuda.bilstm_bwd.launches == bwd0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def _ctc_case(rng, n, t, l, c=64, frames=None):
    """Logits, labels and lengths with a ragged batch (rows of ``frames``,
    (least, most), by default T/2 to T frames), a repeated label, an empty
    label and an infeasible example. At L = 0 every label is empty, in a
    label matrix one wide, as the port's callers pad it
    (``ops/ctc.py:ctc_loss_flat``)."""
    logits = (rng.randn(n, t, c) * 2).astype(np.float32)
    labels = rng.randint(1, c, (n, max(l, 1))).astype(np.int32)
    label_lens = (rng.randint(1, l + 1, n) if l else np.zeros(n)) \
        .astype(np.int32)
    least, most = frames or (max(1, t // 2), t)
    logit_lens = rng.randint(least, most + 1, n).astype(np.int32)
    label_lens[0], logit_lens[0] = l, t
    logit_lens[3] = 1
    if l:
        labels[0, 1] = labels[0, 0]
        label_lens[1] = 0                              # empty label
        label_lens[2], logit_lens[2] = l, min(l - 1, t)   # infeasible
        label_lens[3] = 1
    for i in range(n):
        labels[i, label_lens[i]:] = 0
    return logits, labels, label_lens, logit_lens


@pytest.mark.parametrize('t,l', [
    (23, 6), (111, 24), (1, 2), (40, 63), (140, 64), (300, 200), (600, 511),
    # both sides of each path boundary (S = 31/33: one or two states a lane
    # of the warp kernels; S = 63/65: the block kernels past them), L = 0
    # alone, T = 1, T around one and two of the warp kernels' 16-step chunks
    (50, 15), (50, 16), (100, 31), (100, 32), (160, 64), (560, 511), (23, 0),
    (1, 6), (15, 6), (16, 6), (17, 6), (31, 15), (32, 24), (33, 24),
    # the htr_puigcerver cell's labels at its T; past 511 characters, the
    # block kernels' threads walking several states each
    (224, 24), (1033, 512), (1209, 600), (2057, 1024)])
def test_ctc_kernels_match_reference(cuda_device, t, l):
    """``ctc_fwd``'s logZ and alphas bit-identical to the plain version and
    ``ctc_bwd`` within 1e-5 of it, each called twice with the same bits, on
    a ragged batch of 64 (at :data:`HTR_CTC` the cell's batch, classes and
    frames), with the masks the port's loss builds: the empty label's logZ
    finite, the infeasible example's at -inf with a zero gradient."""
    rng = np.random.RandomState(t + l)
    n, c, frames = HTR_CTC[2:] if (t, l) == HTR_CTC[:2] else (64, 64, None)
    logits, labels, label_lens, logit_lens = _ctc_case(rng, n, t, l, c,
                                                       frames)
    dev = cuda_device
    logp = torch.log_softmax(torch.from_numpy(logits).to(dev), -1)
    ext = ctc.extended_labels(torch.from_numpy(labels).to(dev))
    ll = torch.from_numpy(label_lens).to(dev)
    tl = torch.from_numpy(logit_lens).to(dev)
    skip, final, valid = (ctc._as_additive(m)
                          for m in ctc._transition_masks(ext, ll))
    g = ctc._gather_logp(logp, ext, tl).contiguous()
    f0, b0 = ctc_cuda.ctc_forward.launches, ctc_cuda.ctc_backward.launches
    logz, alphas = ctc_cuda.ctc_forward(g, skip, valid, final)
    fwd_again = ctc_cuda.ctc_forward(g, skip, valid, final)
    grad = ctc_cuda.ctc_backward(g, skip, valid, final, alphas, logz, tl)
    again = ctc_cuda.ctc_backward(g, skip, valid, final, alphas, logz, tl)
    torch.cuda.synchronize()
    assert ctc_cuda.ctc_forward.launches == f0 + 2
    assert ctc_cuda.ctc_backward.launches == b0 + 2
    logz_r, alphas_r = ctc.ctc_forward_reference(g, skip, valid, final)
    grad_r = ctc.ctc_backward_reference(g, skip, valid, final, alphas_r,
                                        logz_r, tl)
    assert torch.equal(logz, logz_r) and torch.equal(alphas, alphas_r)
    assert torch.equal(fwd_again[0], logz) and \
        torch.equal(fwd_again[1], alphas) and torch.equal(again, grad)
    assert float((grad - grad_r).abs().max()) <= 1e-5
    assert bool(torch.isfinite(logz[1]))
    if l:
        assert float(logz[2]) <= ctc.NEG_INF / 2 and not grad[2].any()


@pytest.mark.parametrize('t,l', [(40, 15), (40, 16), (80, 31), (80, 32),
                                 (1, 6), (17, 15), (33, 24), (23, 6),
                                 (111, 24)])
def test_ctc_bwd_paths_on_both_sides_of_each_boundary(cuda_device, t, l):
    """The CTC kernels' warp paths with one state a lane (S = 31), with two
    (S = 33, 49 and 63) and the block kernels past them (S = 65), at T = 1
    and odd T, on a batch of 37 and on its first example alone: ``ctc_fwd``
    bit-identical to the plain version, ``ctc_bwd`` within 1e-5 of it, two
    calls of each bit-identical, and the same bits from copies of the
    inputs that start 4 bytes past a 16-byte boundary."""
    rng = np.random.RandomState(7 * t + l)
    logits, labels, label_lens, logit_lens = _ctc_case(rng, 37, t, l)
    dev = cuda_device
    logp = torch.log_softmax(torch.from_numpy(logits).to(dev), -1)
    ext = ctc.extended_labels(torch.from_numpy(labels).to(dev))
    tl = torch.from_numpy(logit_lens).to(dev)
    skip, final, valid = (ctc._as_additive(m) for m in ctc._transition_masks(
        ext, torch.from_numpy(label_lens).to(dev)))
    g = ctc._gather_logp(logp, ext, tl).contiguous()
    assert g.shape[2] == 2 * l + 1
    logz, alphas = ctc.ctc_forward_reference(g, skip, valid, final)
    f0, b0 = ctc_cuda.ctc_forward.launches, ctc_cuda.ctc_backward.launches
    fwd = ctc_cuda.ctc_forward(g, skip, valid, final)
    fwd_again = ctc_cuda.ctc_forward(g, skip, valid, final)
    grad = ctc_cuda.ctc_backward(g, skip, valid, final, alphas, logz, tl)
    again = ctc_cuda.ctc_backward(g, skip, valid, final, alphas, logz, tl)
    torch.cuda.synchronize()
    assert ctc_cuda.ctc_forward.launches == f0 + 2
    assert ctc_cuda.ctc_backward.launches == b0 + 2
    for got, twice, want in zip(fwd, fwd_again, (logz, alphas)):
        assert torch.equal(got, want) and torch.equal(twice, got)
    assert torch.equal(grad, again)
    grad_r = ctc.ctc_backward_reference(g, skip, valid, final, alphas, logz,
                                        tl)
    assert float(logz[2]) <= ctc.NEG_INF / 2 and not grad[2].any()
    torch.testing.assert_close(grad, grad_r, rtol=1e-5, atol=1e-5)

    def off16(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:].copy_(x.reshape(-1))
        return buf[1:].view(x.shape)
    shifted = [off16(x) for x in (g, skip, valid, final, alphas, logz, tl)]
    assert all(x.data_ptr() % 16 == 4 for x in shifted)
    assert torch.equal(ctc_cuda.ctc_backward(*shifted), grad)
    for got, want in zip(ctc_cuda.ctc_forward(*shifted[:4]), (logz, alphas)):
        assert torch.equal(got, want)

    # N = 1: the first example alone (full length, the longest label), each
    # kernel called twice, against the plain version's first example
    one = [x[:1].contiguous() for x in (g, skip, valid, final)]
    one_bwd = one + [x[:1].contiguous() for x in (alphas, logz, tl)]
    for _ in range(2):
        for got, want in zip(ctc_cuda.ctc_forward(*one), (logz, alphas)):
            assert torch.equal(got, want[:1])
    grad_one = ctc_cuda.ctc_backward(*one_bwd)
    assert torch.equal(ctc_cuda.ctc_backward(*one_bwd), grad_one)
    torch.testing.assert_close(grad_one, grad_r[:1], rtol=1e-5, atol=1e-5)


def test_ctc_loss_on_cuda_matches_cpu(cuda_device):
    rng = np.random.RandomState(5)
    logits, labels, label_lens, logit_lens = _ctc_case(rng, 16, 23, 6)
    wgt = torch.from_numpy(rng.rand(16).astype(np.float32))

    def run(dev, fn):
        x = torch.from_numpy(logits).to(dev).requires_grad_()
        loss = fn(x, *(torch.from_numpy(a).to(dev)
                       for a in (labels, label_lens, logit_lens)))
        (loss * wgt.to(dev)).sum().backward()
        return loss.detach().cpu(), x.grad.cpu()
    f0, b0 = ctc_cuda.ctc_forward.launches, ctc_cuda.ctc_backward.launches
    loss, grad = run(cuda_device, ctc_cuda.ctc_loss)
    assert ctc_cuda.ctc_forward.launches == f0 + 1
    assert ctc_cuda.ctc_backward.launches == b0 + 1
    loss_r, grad_r = run('cpu', ctc.ctc_loss)
    assert float(loss[2]) >= 1e29 and not grad[2].any()
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, grad_r, rtol=1e-5, atol=1e-5)
    # labels past 511 characters go through the block kernels too; held to
    # the plain version on the card (at T = 1203 the log-domain sums reach
    # thousands, whose f32 ulps make the CPU's and the card's expf/logf
    # differ by ~4e-4 in a gradient entry; on one device the two are
    # bit-identical in the forward)
    logits, labels, label_lens, logit_lens = _ctc_case(rng, 16, 1203, 600)
    f0, b0 = ctc_cuda.ctc_forward.launches, ctc_cuda.ctc_backward.launches
    loss, grad = run(cuda_device, ctc_cuda.ctc_loss)
    assert ctc_cuda.ctc_forward.launches == f0 + 1
    assert ctc_cuda.ctc_backward.launches == b0 + 1
    loss_r, grad_r = run(cuda_device, ctc.ctc_loss)
    assert torch.equal(loss, loss_r)
    torch.testing.assert_close(grad, grad_r, rtol=1e-5, atol=1e-5)


def test_training_kernels_reject_bad_inputs(cuda_device):
    g = torch.zeros(2, 3, 5, device=cuda_device)
    row = torch.zeros(2, 5, device=cuda_device)
    with pytest.raises(ValueError, match='skip'):
        ctc_cuda.ctc_forward(g, row[:, :4], row, row)
    with pytest.raises(ValueError, match='S >= 1'):
        ctc_cuda.ctc_forward(torch.zeros(1, 2, 0, device=cuda_device),
                             row, row, row)
    with pytest.raises(ValueError, match='lens'):
        ctc_cuda.ctc_backward(g, row, row, row, g, row[:, 0].contiguous(),
                              torch.ones(2, dtype=torch.int64,
                                         device=cuda_device))
    wide = torch.zeros(3, 2, 1024, device=cuda_device)
    narrow = torch.zeros(3, 2, 256, device=cuda_device)
    u = torch.zeros(256, 1024, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match='dob'):
        rnn_cuda.bilstm_bwd(narrow, narrow[:2], wide, narrow, narrow, wide,
                            narrow, narrow, u, u, lens)
    with pytest.raises(TypeError, match='bf16 or f32'):
        rnn_cuda.bilstm_bwd(*(x.half() for x in (
            narrow, narrow, wide, narrow, narrow, wide, narrow, narrow, u,
            u)), lens)


def _lstm_case(rng, dev, dt, t, n, h):
    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dt)
    lens = rng.randint(0, t + 1, n).astype(np.int32)
    lens[0], lens[1] = 0, t
    return mk, (mk(t, n, 4 * h), mk(h, 4 * h, scale=h ** -0.5),
                mk(4 * h, scale=0.1), torch.from_numpy(lens).to(dev))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n,h', [(23, 64, 512), (7, 37, 512), (9, 5, 256),
                                   (1, 3, 8), (111, 64, 512), (23, 37, 512)])
def test_lstm_kernels_match_reference(cuda_device, dtype, t, n, h):
    """``lstm_fwd`` (residuals off and on) and ``lstm_bwd`` on the forward's
    residuals, at the stacked head's H = 512 and below."""
    dt = getattr(torch, dtype)
    mk, args = _lstm_case(np.random.RandomState(t * n + h), cuda_device, dt,
                          t, n, h)
    before = rnn_cuda.lstm_fwd.launches
    out = rnn_cuda.lstm_fwd(*args)
    got = rnn_cuda.lstm_fwd(*args, save_residuals=True)
    assert rnn_cuda.lstm_fwd.launches == before + 2
    want = rnn_cuda.lstm_fwd_reference(*args, save_residuals=True)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 4
    assert torch.equal(out, got[0])
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        w = w.float()
        assert float((g.float() - w).abs().max()) <= _atol(w, dt)

    bwd_args = (mk(t, n, h),) + got[1:] + (args[1], args[3])
    before = rnn_cuda.lstm_bwd.launches
    got = rnn_cuda.lstm_bwd(*bwd_args)
    assert rnn_cuda.lstm_bwd.launches == before + 1
    want = rnn_cuda.lstm_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == (dt if i == 0 else torch.float32)
        assert g.shape == w.shape
        w = w.float()
        scale = max(float(w.abs().max()), 1e-6)
        tol = 1e-4 * scale if dt == torch.float32 else 4 * scale / 256.0
        assert float((g.float() - w).abs().max()) <= tol, i


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n,h', [
    (23, 37, 512), (1, 5, 256), (11, 1, 8), (6, 20, 136), (4, 17, 264)])
def test_lstm_bwd_kernel_edges_and_determinism(cuda_device, dtype, t, n, h):
    """``lstm_bwd`` at the edges of the bf16 cluster tiling: rows that die
    at different t inside one 16-row group and a row of length 0; T = 1; a
    partial last row group (N = 37, 1, 5, 20, 17); H from one block of 8
    units to 16 blocks of 32, and H = 136 and 264, whose last cluster block
    owns fewer units than the others. Two calls are bit-identical."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(7 * t + n + h)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens = (np.arange(n) * 5) % (t + 1)
    lens[0], lens[-1] = 0, t
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda_device)
    u = mk(h, 4 * h, scale=h ** -0.5)
    _, gates, hs, cs = rnn_cuda.lstm_fwd(mk(t, n, 4 * h), u,
                                         mk(4 * h, scale=0.1), lens,
                                         save_residuals=True)
    args = (mk(t, n, h), gates, hs, cs, u, lens)
    before = rnn_cuda.lstm_bwd.launches
    got = rnn_cuda.lstm_bwd(*args)
    again = rnn_cuda.lstm_bwd(*args)
    assert rnn_cuda.lstm_bwd.launches == before + 2
    want = rnn_cuda.lstm_bwd_reference(*args)
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a) and g.shape == w.shape, i
        w = w.float()
        scale = max(float(w.abs().max()), 1e-6)
        tol = 1e-4 * scale if dt == torch.float32 else 4 * scale / 256.0
        assert float((g.float() - w).abs().max()) <= tol, i
    dead = torch.arange(t, device=cuda_device)[:, None] >= lens[None, :]
    assert not got[0][dead].any()           # dead steps: dg = 0


@pytest.mark.parametrize('t', [23, 111])
def test_lstm_scan_pair_matches_the_fused_bilstm(cuda_device, t):
    """The BiLSTM as two scans of kernel 5 (``bilstm_scan_pair`` with
    ``scan=rnn.lstm``, the A/B of the JAX package's ``tools/bench_rnn.py``)
    against the fused kernel 1, bf16, batch 64, H = 256, the eval buckets'
    T: two [D, 4H] projections where the fused path takes one [D, 8H], so
    cuBLAS may round a bf16 projection entry the other way; outputs are
    below 1, and the bar is 8 bf16 ulps of 1."""
    g = torch.Generator().manual_seed(t)
    d, h, n = 512, 256, 64

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=g) * scale).to(cuda_device,
                                                             torch.bfloat16)
    cells = {k: {'w': rnd(d, 4 * h, scale=d ** -0.5),
                 'u': rnd(h, 4 * h, scale=h ** -0.5),
                 'bias': rnd(4 * h, scale=0.1)} for k in ('fw', 'bw')}
    x = rnd(n, t, d, scale=0.5)
    lens = torch.randint(max(1, t - 8), t + 1, (n,), generator=g) \
        .to(cuda_device, torch.int32)
    with torch.no_grad():
        pair = rnn.bilstm_scan_pair(cells, x, lens, scan=rnn.lstm)
        fused = rnn.bilstm(cells, x, lens)
    torch.cuda.synchronize()
    assert float((pair.float() - fused.float()).abs().max()) <= 8 / 256


def test_lstm_gradients_through_kernels(cuda_device):
    """``ops/rnn.lstm`` under autograd on CUDA tensors: one forward and one
    backward launch, output and gradients equal to the CPU (plain) ones."""
    gen = torch.Generator().manual_seed(2)
    d, h, n, t = 32, 16, 5, 9
    cell = {'w': torch.randn(d, 4 * h, generator=gen) * 0.3,
            'u': torch.randn(h, 4 * h, generator=gen) * 0.3,
            'bias': torch.randn(4 * h, generator=gen) * 0.1}
    x = torch.randn(t, n, d, generator=gen)
    wgt = torch.randn(t, n, h, generator=gen)
    lens = torch.tensor([9, 0, 4, 1, 7], dtype=torch.int32)

    def run(dev):
        c = {p: v.clone().to(dev).requires_grad_() for p, v in cell.items()}
        xd = x.clone().to(dev).requires_grad_()
        out = rnn.lstm(c, xd, lens.to(dev))
        (out * wgt.to(dev)).sum().backward()
        return [out.detach().cpu(), xd.grad.cpu()] + [
            c[p].grad.cpu() for p in ('w', 'u', 'bias')]
    want = run('cpu')
    fwd0, bwd0 = rnn_cuda.lstm_fwd.launches, rnn_cuda.lstm_bwd.launches
    got = run(cuda_device)
    assert rnn_cuda.lstm_fwd.launches == fwd0 + 1
    assert rnn_cuda.lstm_bwd.launches == bwd0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_lstm_kernels_reject_bad_inputs(cuda_device):
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    # past the wide recurrence's shared memory; the width is checked first
    h = rnn_cuda.MAX_HIDDEN + 8
    x = torch.zeros(3, 2, 4 * h, device=cuda_device)
    u = torch.zeros(16, 64, device=cuda_device)
    with pytest.raises(ValueError, match='hidden size'):
        rnn_cuda.lstm_fwd(x, u, x[0, 0], lens)
    with pytest.raises(ValueError, match='hidden size'):
        rnn_cuda.lstm_bwd(x[..., :h], x, x[..., :h], x[..., :h], u, lens)
    x, u = x[..., :64].contiguous(), u[:16, :64].contiguous()
    with pytest.raises(ValueError, match='lens'):
        rnn_cuda.lstm_fwd(x, u, x[0, 0], lens.long())
    with pytest.raises(TypeError, match='bf16 or f32'):
        rnn_cuda.lstm_fwd(x.half(), u.half(), x[0, 0].half(), lens)
    with pytest.raises(ValueError, match='dout'):
        rnn_cuda.lstm_bwd(x[:2, :, :16], x, x[..., :16], x[..., :16], u, lens)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n,w,h,ci,co', [(64, 24, 4, 256, 512),
                                         (16, 24, 4, 32, 48),
                                         (8, 12, 2, 64, 64),
                                         (6, 10, 4, 16, 32),
                                         # the bf16 tile's edges: N = 1,
                                         # C_in = 16 and 272 (not a multiple
                                         # of the 32-channel step), M = N W H
                                         # not a multiple of 128, C_out 48
                                         # and odd
                                         (1, 24, 4, 16, 48),
                                         (5, 13, 3, 272, 48),
                                         (2, 9, 5, 48, 37),
                                         # conv4_2 at batch 64; C_in 1 (a
                                         # first layer) and 24, zero
                                         # channels up to 16 and 32
                                         (64, 24, 4, 512, 512),
                                         (64, 96, 32, 1, 64),
                                         (64, 24, 4, 24, 128)])
def test_conv_bn_kernel_matches_reference(cuda_device, dtype, n, w, h, ci, co):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(n * co)

    def mk(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32)).to(cuda_device)
    args = (mk(n, ci, w, h).to(dt), mk(co, ci, 3, 3, scale=0.1),
            mk(co, scale=0.1), mk(co, scale=0.1, shift=1.0),
            mk(co, scale=0.1))
    before = conv_bn_cuda.conv3x3_bn_relu.launches
    got = conv_bn_cuda.conv3x3_bn_relu(*args)
    again = conv_bn_cuda.conv3x3_bn_relu(*args)
    assert conv_bn_cuda.conv3x3_bn_relu.launches == before + 2
    want = conv_bn_cuda.conv3x3_bn_relu_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == want.shape == (n, co, w, h)
    assert torch.equal(got, again)          # fixed-order sums: bit for bit
    tol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', bench_conv_bn.SHAPES,
                         ids=[tag for tag, *_ in bench_conv_bn.SHAPES])
def test_conv_bn_kernel_matches_the_unfused_layer(cuda_device, dtype, shape):
    """The fused kernel against the layer it replaces (``ConvSingle``:
    cuDNN's conv, then bias, batch norm and ReLU) at the conv4_1 and conv4_2
    geometry, batch 64, at the plain version's bars: the layer rounds the
    bias apart, takes the two-pass variance and sums in cuDNN's order; its
    f32 conv in full f32 (no TF32), as the plain version computes."""
    from lstm_ctc_ocr_torch.engine.test import full_f32
    _, w, h, ci, co = shape
    dt = getattr(torch, dtype)
    case = bench_conv_bn.make_case(64, w, h, ci, co, dt, cuda_device)
    with torch.no_grad(), full_f32():
        got = conv_bn_cuda.conv3x3_bn_relu(*bench_conv_bn.fused_args(case))
        want = bench_conv_bn.unfused_layer(case)(
            case['x'], None if dt == torch.float32 else dt)
    torch.cuda.synchronize()
    tol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_conv_bn_kernel_takes_channels_last_input(cuda_device, dtype):
    """An ``x`` whose memory is already channels-last skips the kernel's
    layout launch and gives the same bits as the standard layout."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3)

    def mk(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32)).to(cuda_device)
    x = mk(4, 48, 10, 3).to(dt)
    args = (mk(40, 48, 3, 3, scale=0.1), mk(40, scale=0.1),
            mk(40, scale=0.1, shift=1.0), mk(40, scale=0.1))
    x_cl = x.contiguous(memory_format=torch.channels_last)
    assert not x_cl.is_contiguous()
    got = conv_bn_cuda.conv3x3_bn_relu(x_cl, *args)
    want = conv_bn_cuda.conv3x3_bn_relu(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_conv_bn_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(2, 16, 4, 4, device=cuda_device)
    k = torch.zeros(8, 16, 3, 3, device=cuda_device)
    v = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match='kernel'):
        conv_bn_cuda.conv3x3_bn_relu(x, k[:, :, :2], v, v, v)
    with pytest.raises(ValueError, match='gamma'):
        conv_bn_cuda.conv3x3_bn_relu(x, k, v, v[:4], v)
    with pytest.raises(TypeError, match='bf16 or f32'):
        conv_bn_cuda.conv3x3_bn_relu(x.half(), k, v, v, v)


def _launches():
    return {'bilstm_fwd': rnn_cuda.bilstm_fwd.launches,
            'bilstm_bwd': rnn_cuda.bilstm_bwd.launches,
            'ctc_fwd': ctc_cuda.ctc_forward.launches,
            'ctc_bwd': ctc_cuda.ctc_backward.launches}


def test_synthetic_train_steps_launch_each_kernel_once(cuda_device,
                                                       tmp_path):
    """``train_net`` on the default synthetic stream (``RENDERER native``,
    two workers forked after CUDA has started): each of the four kernels of
    the BiLSTM step launches once a step, ``bilstm_fwd`` also once for the
    validation decode on the synthetic validation batch."""
    from lstm_ctc_ocr_torch.config import load_cfg
    from lstm_ctc_ocr_torch.engine import train
    from lstm_ctc_ocr_torch.models.factory import get_network
    yml = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'lstm', 'lstm.yml')
    cfg = load_cfg(yml, [
        'RENDERER', 'native', 'TRAIN.BATCH_SIZE', '16', 'VAL.BATCH_SIZE',
        '16', 'TRAIN.NUM_WORKERS', '2', 'VAL.VAL_STEP', '3',
        'TRAIN.DISPLAY', '1'])
    assert str(cfg.DATA_BACKEND) == 'synth'
    net = get_network('LSTM_train', cfg,
                      generator=torch.Generator().manual_seed(3))
    before = _launches()
    _, _, losses = train.train_net(net, {}, None, str(tmp_path / 'out'),
                                   str(tmp_path / 'log'), cfg, max_iters=5,
                                   device='cuda')
    after = _launches()
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert {k: after[k] - before[k] for k in after} == {
        'bilstm_fwd': 4 + 1, 'bilstm_bwd': 4, 'ctc_fwd': 4, 'ctc_bwd': 4}


def test_fork_workers_stream_in_a_cuda_process(cuda_device):
    """Worker processes forked from a process that holds a CUDA context
    render batches (they never touch CUDA), and the parent's CUDA work goes
    on after they stop."""
    from lstm_ctc_ocr_torch.config import load_cfg
    from lstm_ctc_ocr_torch.data import gen
    x = torch.arange(8.0, device=cuda_device)
    torch.cuda.synchronize()
    cfg = load_cfg(None, ['RENDERER', 'native', 'MP_START', 'fork'])
    stream = gen.get_batch(cfg, num_workers=2, seed=9, batch_size=8)
    try:
        batches = [next(stream) for _ in range(4)]
    finally:
        stream.close()
    for b in batches:
        img = torch.from_numpy(b.image).to(cuda_device)
        assert img.shape[0] == 8 and int(img.max()) > 0
    assert len({b.label.tobytes() for b in batches}) == 4
    assert float((x * 2).sum()) == 56.0


def test_cuda_program_launches_the_kernel(cuda_device, tmp_path):
    """On the card the exported program launches kernel 1 once a call and
    gives the live decode's ids."""
    from lstm_ctc_ocr_torch.config import load_cfg
    from lstm_ctc_ocr_torch.engine import serve
    from lstm_ctc_ocr_torch.engine import test as test_mod
    from lstm_ctc_ocr_torch.models.factory import get_network
    cfg = load_cfg(None, ['TEST.BATCH_SIZE', '4', 'TRAIN.DTYPE',
                          "'bfloat16'"])
    model = get_network('LSTM_test', cfg,
                        generator=torch.Generator().manual_seed(0))
    serve.export_decoder(model, cfg, str(tmp_path), buckets=[96], batch=4)
    dec = serve.ExportedDecoder(str(tmp_path))
    img = np.random.RandomState(0).rand(4, 96, 32).astype(np.float32)
    ts = np.array([23, 20, 9, 1], np.int32)
    before = rnn_cuda.bilstm_fwd.launches
    got = dec.run(img, ts)
    assert rnn_cuda.bilstm_fwd.launches == before + 1
    with test_mod.full_f32():
        want = test_mod.make_decode_step(model, cfg, cuda_device)(img, ts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n,h', WIDTH_CASES)
def test_kernels_take_every_width(cuda_device, dtype, t, n, h):
    """All four LSTM wrappers at the widths of :data:`WIDTH_CASES`: H = 50
    (no multiple of 8: zero-padded), 300 and 512 per direction (bf16
    cluster, f32 wide), 768 and 1024 (wide in both types), each at batch 64
    and the eval buckets' T, on ragged batches of 37 with an empty row and
    at T = 1: forward (residuals on) and backward against the plain
    versions at the bars above (the backward's relative to each output's
    largest entry), each kernel called twice with the same bits and
    launched once a call, the forwards' outputs zero past each row's
    length."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(h + 1000 * t + n)
    mk, (xp, u, b, lens) = _lstm_case(rng, cuda_device, dt, t, n, h)
    ub, bb, xpb = mk(h, 4 * h, scale=h ** -0.5), mk(4 * h, scale=0.1), \
        mk(t, n, 4 * h)
    dof, dob = mk(t, n, h), mk(t, n, h)
    fwd_args = (xp, xpb, u, ub, b, bb, lens)
    want = rnn_cuda.bilstm_fwd_reference(*fwd_args, save_residuals=True)
    want_u = rnn_cuda.lstm_fwd_reference(xp, u, b, lens, save_residuals=True)
    bwd_args = (dof, dob) + want[1:4] + want[5:8] + (u, ub, lens)
    uni_bwd_args = (dof,) + want_u[1:] + (u, lens)
    calls = [(rnn_cuda.bilstm_fwd, rnn_cuda.bilstm_fwd_reference, fwd_args,
              {'save_residuals': True}, (0, 4)),
             (rnn_cuda.bilstm_bwd, rnn_cuda.bilstm_bwd_reference, bwd_args,
              {}, None),
             (rnn_cuda.lstm_fwd, rnn_cuda.lstm_fwd_reference,
              (xp, u, b, lens), {'save_residuals': True}, (0,)),
             (rnn_cuda.lstm_bwd, rnn_cuda.lstm_bwd_reference, uni_bwd_args,
              {}, None)]
    for kernel, plain, args, kw, outputs in calls:
        before = kernel.launches
        got, again = kernel(*args, **kw), kernel(*args, **kw)
        assert kernel.launches == before + 2
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        if outputs is not None:
            _check_fwd(got, again, ref, dt, lens, outputs)
            continue
        for i, (g, a, w) in enumerate(zip(got, again, ref)):
            assert torch.equal(g, a) and g.shape == w.shape, i
            w = w.float()
            scale = max(float(w.abs().max()), 1e-6)
            bar = 1e-4 * scale if dt == torch.float32 else 4 * scale / 256
            assert float((g.float() - w).abs().max()) <= bar, i


@pytest.mark.parametrize('ci', [1, 24])
def test_conv_bn_kernel_takes_any_input_channels(cuda_device, ci):
    """C_in that is no multiple of 16 gets zero channels up to one; the
    result keeps the bars above against the plain version."""
    rng = np.random.RandomState(ci)
    for dt, bar in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        def mk(*shape, scale=1.0, shift=0.0):
            return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                    .astype(np.float32)).to(cuda_device)
        x = mk(4, ci, 10, 6).to(dt)
        args = (mk(40, ci, 3, 3, scale=0.3), mk(40, scale=0.1),
                mk(40, scale=0.1, shift=1.0), mk(40, scale=0.1))
        before = conv_bn_cuda.conv3x3_bn_relu.launches
        got = conv_bn_cuda.conv3x3_bn_relu(x, *args)
        want = conv_bn_cuda.conv3x3_bn_relu_reference(x, *args)
        torch.cuda.synchronize()
        assert conv_bn_cuda.conv3x3_bn_relu.launches == before + 1
        assert got.shape == want.shape == (4, 40, 10, 6)
        torch.testing.assert_close(got.float(), want.float(), rtol=bar,
                                   atol=bar)
