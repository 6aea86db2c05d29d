"""The port's plain CTC against the JAX package's.

The same numpy-seeded logits and labels go through the JAX scan CTC
(``ops/ctc.py``), the JAX Pallas CTC (``ops/ctc_pallas.py``, in interpret
mode off the TPU, as tests/test_ctc_pallas.py runs it) and the port's plain
version (``lstm_ctc_ocr_torch/ops/ctc.py``), which is also what the CUDA
kernels of ``ops/ctc_cuda.py`` are held to on the card
(tests/test_torch_cuda.py). Tolerance: 1e-5 absolute and relative on loss
and gradient, the repo's standing CTC bar; every case has ragged lengths, a
repeated label, an empty label (L=0) and an infeasible example.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.ops import ctc as jctc
from lstm_ctc_ocr_tpu.ops import ctc_pallas
from lstm_ctc_ocr_torch.ops import ctc, ctc_cuda


def _case(seed, n=8, t=12, l=4, c=9):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t, c) * 2).astype(np.float32)
    labels = rng.randint(1, c, (n, l)).astype(np.int32)
    label_lens = rng.randint(1, l + 1, n).astype(np.int32)
    logit_lens = rng.randint(max(1, t // 2), t + 1, n).astype(np.int32)
    if l > 1:
        labels[0, 1] = labels[0, 0]                    # repeated label
    label_lens[0], logit_lens[0] = l, t
    label_lens[1] = 0                                  # empty label
    label_lens[2], logit_lens[2] = l, max(l - 1, 1)    # infeasible if l > 1
    label_lens[3], logit_lens[3] = 1, 1                # one frame, one char
    for i in range(n):
        labels[i, label_lens[i]:] = 0
    weights = rng.rand(n).astype(np.float32) + 0.5
    return logits, labels, label_lens, logit_lens, weights


def _jax_loss_and_grad(fn, case, dtype=jnp.float32):
    logits, labels, label_lens, logit_lens, weights = case
    args = tuple(jnp.asarray(a) for a in (labels, label_lens, logit_lens))
    x = jnp.asarray(logits).astype(dtype)
    loss = fn(x, *args)
    grad = jax.grad(lambda v: jnp.sum(fn(v, *args) * weights))(x)
    return np.asarray(loss), np.asarray(grad.astype(jnp.float32))


def _torch_loss_and_grad(fn, case, dtype=torch.float32):
    logits, labels, label_lens, logit_lens, weights = case
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    loss = fn(x, *(torch.from_numpy(a)
                   for a in (labels, label_lens, logit_lens)))
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize('seed,t,l,c', [(0, 12, 4, 9), (1, 16, 6, 12),
                                        (2, 1, 1, 5), (3, 9, 1, 3),
                                        (4, 5, 6, 12)])
def test_loss_and_gradient_match_jax_scan(seed, t, l, c):
    case = _case(seed, t=t, l=l, c=c)
    want_loss, want_grad = _jax_loss_and_grad(jctc.ctc_loss, case)
    got_loss, got_grad = _torch_loss_and_grad(ctc.ctc_loss, case)
    assert got_loss.dtype == np.float32
    if l > 1:
        assert got_loss[2] == np.float32(1e30) and not got_grad[2].any()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-5)
    assert not got_grad[np.arange(t)[None, :] >= case[3][:, None]].any()


@pytest.mark.parametrize('seed,t,l', [(10, 8, 3), (11, 12, 5)])
def test_loss_and_gradient_match_jax_pallas(seed, t, l):
    case = _case(seed, t=t, l=l, c=9)
    want_loss, want_grad = _jax_loss_and_grad(ctc_pallas.ctc_loss_pallas, case)
    got_loss, got_grad = _torch_loss_and_grad(ctc.ctc_loss, case)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-5)


def test_bf16_logits_are_widened_like_jax():
    """bf16 logits: both packages widen to f32 before the log-softmax, and
    the gradient comes back in bf16."""
    case = _case(20)
    want_loss, want_grad = _jax_loss_and_grad(jctc.ctc_loss, case,
                                              jnp.bfloat16)
    got_loss, got_grad = _torch_loss_and_grad(ctc.ctc_loss, case,
                                              torch.bfloat16)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=1e-5)
    # the gradients are rounded to bf16 on both sides: one bf16 ulp
    np.testing.assert_allclose(got_grad, want_grad, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize('seed,t,l', [(30, 8, 3), (31, 11, 5), (32, 1, 2)])
def test_kernel_contract_references_match_pallas_kernels(seed, t, l):
    """``ctc_forward_reference`` / ``ctc_backward_reference`` take and give
    what ``_run_forward`` / ``_run_backward`` take and give (those pad the
    batch to 8 rows and S to 128 lanes; the comparison strips the pad)."""
    logits, labels, label_lens, logit_lens, _ = _case(seed, n=8, t=t, l=l)
    s = 2 * l + 1
    jlogp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    g, skip, valid, final, _, n_pad = ctc_pallas._pad_args(
        jlogp, jnp.asarray(labels), jnp.asarray(label_lens),
        jnp.asarray(logit_lens))
    assert n_pad == 8
    logz, alphas = ctc_pallas._run_forward(g, skip, valid, final)
    grad_g = ctc_pallas._run_backward(
        g, skip, valid, final, alphas, logz,
        jnp.asarray(logit_lens)[:, None])

    def t_(x, width=s):
        return torch.from_numpy(np.asarray(x)[..., :width].copy())
    tg = t_(g)
    masks = (t_(skip), t_(valid), t_(final))
    got_logz, got_alphas = ctc.ctc_forward_reference(tg, *masks)
    got_grad = ctc.ctc_backward_reference(
        tg, *masks, got_alphas, got_logz, torch.from_numpy(logit_lens))
    np.testing.assert_allclose(got_logz.numpy(), np.asarray(logz)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_alphas.numpy(),
                               np.asarray(alphas)[..., :s], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(grad_g)[..., :s],
                               rtol=1e-5, atol=1e-5)
    # the masks and the gather themselves
    tlabels = torch.from_numpy(labels)
    ext = ctc.extended_labels(tlabels)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(jctc.extended_labels(jnp.asarray(labels))))
    t_skip, t_final, t_valid = ctc._transition_masks(
        ext, torch.from_numpy(label_lens))
    for got, want in zip((t_skip, t_valid, t_final), masks):
        np.testing.assert_array_equal(ctc._as_additive(got).numpy(),
                                      want.numpy())
    got_g = ctc._gather_logp(torch.log_softmax(torch.from_numpy(logits), -1),
                             ext, torch.from_numpy(logit_lens))
    np.testing.assert_allclose(got_g.numpy(), tg.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_flat_label_wrapper_matches_jax():
    logits, labels, label_lens, logit_lens, _ = _case(40)
    flat = np.concatenate([labels[i, :k] for i, k in enumerate(label_lens)])
    logits_tm = np.swapaxes(logits, 0, 1).copy()
    want = np.asarray(jctc.ctc_loss_flat(logits_tm, flat, label_lens,
                                         logit_lens))
    got = ctc.ctc_loss_flat(torch.from_numpy(logits_tm), flat, label_lens,
                            logit_lens).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dispatch_on_cpu_is_the_plain_version():
    """``ctc_cuda.ctc_loss`` on CPU tensors runs the plain recursions and
    launches nothing, also for labels past the 63 characters at which the JAX
    package leaves its kernel: the port's kernels take labels of any length,
    and nothing switches to the plain version by length."""
    assert (ctc_pallas.LANES - 1) // 2 == 63
    assert ctc_cuda.WARP_MAX_STATES == 64
    case = _case(50)
    want = _torch_loss_and_grad(ctc.ctc_loss, case)
    got = _torch_loss_and_grad(ctc_cuda.ctc_loss, case)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    rng = np.random.RandomState(51)
    n, t, l, c = 2, 140, 64, 6
    logits = rng.randn(n, t, c).astype(np.float32)
    labels = rng.randint(1, c, (n, l)).astype(np.int32)
    lens = (np.array([l, 10], np.int32), np.array([t, 30], np.int32))
    labels[1, 10:] = 0
    got = ctc_cuda.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                            *(torch.from_numpy(a) for a in lens)).numpy()
    want = np.asarray(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    *(jnp.asarray(a) for a in lens)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ctc_cuda.ctc_forward.launches == 0
    assert ctc_cuda.ctc_backward.launches == 0


def test_cuda_loss_raises_past_the_kernels_capacity():
    """The kernels have no capacity left to pass: a label of 600 characters
    on a tensor off the CPU goes to the kernel wrappers, which raise for a
    device they do not run on; it never takes the plain version."""
    long = torch.ones(2, 600, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CUDA or CPU tensors, got meta'):
        ctc_cuda.ctc_loss(torch.zeros(2, 1300, 8, device='meta'), long,
                          torch.ones(2, dtype=torch.int32, device='meta'),
                          torch.full((2,), 1300, dtype=torch.int32,
                                     device='meta'))
    assert ctc_cuda.ctc_forward.launches == 0