"""CTC at label lengths past 511 characters, the port against the JAX
package.

The JAX package trains any label length: its default ``CTC_IMPL`` is the
``lax.scan`` loss (``ops/ctc.py:ctc_loss``), and its Pallas kernel hands
labels past 63 characters to it. The port's kernels take any length too
(``csrc/ctc.cu``'s block kernels walk several states a thread); on the
CPU both the plain recursions (``ops/ctc.py``) and the dispatch
(``ops/ctc_cuda.py:ctc_loss``, which takes the plain versions for CPU
tensors and launches nothing) must match the JAX scan at L = 600: loss and
gradient within 1e-5 absolute and relative, the repo's standing CTC bar.
The batch is ragged, with an empty label, an infeasible example and a
one-frame example. The kernels themselves are held to the plain version at
L = 512, 600 and 1024 on the card (chip_smoke.py's phase 14,
tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.ops import ctc as jctc
from lstm_ctc_ocr_torch.ops import ctc, ctc_cuda


def _case(seed, n, t, l, c=12):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t, c) * 2).astype(np.float32)
    labels = rng.randint(1, c, (n, l)).astype(np.int32)
    label_lens = rng.randint(l // 2, l + 1, n).astype(np.int32)
    logit_lens = rng.randint(2 * l + 1, t + 1, n).astype(np.int32)
    labels[0, 1] = labels[0, 0]                        # repeated label
    label_lens[0], logit_lens[0] = l, t
    label_lens[1] = 0                                  # empty label
    label_lens[2], logit_lens[2] = l, l - 1            # infeasible
    label_lens[3], logit_lens[3] = 1, 1                # one frame, one char
    for i in range(n):
        labels[i, label_lens[i]:] = 0
    weights = rng.rand(n).astype(np.float32) + 0.5
    return logits, labels, label_lens, logit_lens, weights


@pytest.mark.parametrize('fn', ['plain', 'dispatch'])
def test_loss_and_gradient_at_600_characters_match_jax_scan(fn):
    logits, labels, label_lens, logit_lens, weights = _case(600, 5, 1250,
                                                            600)
    args = tuple(jnp.asarray(a) for a in (labels, label_lens, logit_lens))
    x = jnp.asarray(logits)
    want = np.asarray(jctc.ctc_loss(x, *args))
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(jctc.ctc_loss(v, *args) * weights))(x))

    loss_fn = ctc.ctc_loss if fn == 'plain' else ctc_cuda.ctc_loss
    xt = torch.from_numpy(logits).requires_grad_()
    loss = loss_fn(xt, *(torch.from_numpy(a)
                         for a in (labels, label_lens, logit_lens)))
    (loss * torch.from_numpy(weights)).sum().backward()
    assert 2 * labels.shape[1] + 1 == 1201        # states past one block
    assert float(loss.detach()[2]) >= 1e29 and not xt.grad[2].any()
    assert np.isfinite(want[[0, 1, 3, 4]]).all()
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-5)
    assert ctc_cuda.ctc_forward.launches == ctc_cuda.ctc_backward.launches == 0
