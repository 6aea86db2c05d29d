"""The port's C++ CTC oracle (``native/ctc_ref.py`` + ``ctc_ref.cpp``).

* Bit-identical to the JAX package's oracle (``lstm_ctc_ocr_tpu/native/
  ctc_ref.py``) on ragged batches with an empty label, an infeasible
  example, a one-frame example and a zero-frame example: losses and
  gradients, with and without the gradient.
* The port's plain CTC (``ops/ctc.py:ctc_loss`` and its autograd
  backward) against it: the loss within 1e-5 relative; each example's
  gradient within ``max(1e-5, 1e-6 * loss)`` absolute, since the f32
  log-space sums alpha + beta - log Z, whose size is the loss, round to
  ~1e-7 of it and the posteriors carry that (measured 1.5-3e-5 at T=23
  and 1.3-3.1e-4 at T=111 with logits of scale 2; the JAX package's own
  test holds its scan to 1e-4 at T=90); the plain version's 1e30 sentinel
  where the oracle gives +inf, with both gradients zero there.
* The same input checks as the JAX oracle (``tests/test_ctc_native.py``):
  an out-of-range label id or length raises ``AssertionError``.
"""

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_tpu.native import ctc_ref as jctc_ref
from lstm_ctc_ocr_torch.native import ctc_ref
from lstm_ctc_ocr_torch.ops import ctc


def _case(n, t, l_max, c=64, seed=0):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(n, t, c)).astype(np.float32)
    labels = rng.randint(1, c, (n, l_max)).astype(np.int32)
    label_lens = rng.randint(1, l_max + 1, n).astype(np.int32)
    logit_lens = rng.randint(max(1, t // 2), t + 1, n).astype(np.int32)
    label_lens[0], logit_lens[0] = l_max, t
    if n > 3:
        label_lens[1] = 0                          # empty label
        label_lens[2], logit_lens[2] = l_max, 1    # infeasible
        label_lens[3], logit_lens[3] = 1, 1        # one frame
        labels[4, :3] = 7                          # repeats need blanks
        label_lens[4], logit_lens[4] = 3, 5
    for i in range(n):
        labels[i, label_lens[i]:] = 0
    return logits, labels, label_lens, logit_lens


CASES = [(64, 23, 6), (64, 111, 24), (5, 9, 4), (1, 1, 1)]


@pytest.mark.parametrize('n,t,l_max', CASES)
def test_bit_identical_to_the_jax_oracle(n, t, l_max):
    args = _case(n, t, l_max)
    for want_grad in (True, False):
        got = ctc_ref.ctc_loss_grad(*args, want_grad=want_grad)
        want = jctc_ref.ctc_loss_grad(*args, want_grad=want_grad)
        np.testing.assert_array_equal(got[0], want[0])
        if want_grad:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None


def test_zero_frames():
    logits, labels, label_lens, _ = _case(3, 6, 2)
    lens = np.array([0, 0, 6], np.int32)
    label_lens[1] = 0
    got = ctc_ref.ctc_loss_grad(logits, labels, label_lens, lens)
    want = jctc_ref.ctc_loss_grad(logits, labels, label_lens, lens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert np.isinf(got[0][0]) and got[0][1] == 0.0


@pytest.mark.parametrize('n,t,l_max', CASES)
def test_plain_ctc_against_the_oracle(n, t, l_max):
    logits, labels, label_lens, logit_lens = _case(n, t, l_max, seed=1)
    ref_loss, ref_grad = ctc_ref.ctc_loss_grad(logits, labels, label_lens,
                                               logit_lens)
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc.ctc_loss(x, torch.from_numpy(labels),
                        torch.from_numpy(label_lens),
                        torch.from_numpy(logit_lens))
    feasible = np.isfinite(ref_loss)
    got = loss.detach().numpy()
    np.testing.assert_array_equal(got >= 1e29, ~feasible)
    np.testing.assert_allclose(got[feasible], ref_loss[feasible], rtol=1e-5,
                               atol=0)
    torch.where(loss < 1e29, loss, torch.zeros_like(loss)).sum().backward()
    err = np.abs(x.grad.numpy() - ref_grad).max(axis=(1, 2))
    bar = np.maximum(1e-5, 1e-6 * np.where(feasible, ref_loss, 0.0))
    assert (err <= bar).all(), (err / bar).max()
    assert not ref_grad[~feasible].any() and not x.grad[~feasible].any()


def test_rejects_out_of_range_inputs():
    logits = np.zeros((1, 5, 4), np.float32)
    good = np.array([[1, 2]], np.int32)
    for labels, l_len, t_len in [(np.array([[1, 4]], np.int32), 2, 5),
                                 (np.array([[1, -1]], np.int32), 2, 5),
                                 (good, 3, 5), (good, 2, 9), (good, -1, 5)]:
        with pytest.raises(AssertionError):
            ctc_ref.ctc_loss_grad(logits, labels,
                                  np.array([l_len], np.int32),
                                  np.array([t_len], np.int32))
