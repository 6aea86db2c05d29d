"""The port's greedy CTC decode against the JAX package's: identical dense
0-padded id matrices on random logits (continuous, so argmax has no ties)
with ragged lengths, including 0 and full length."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_ctc_ocr_tpu.ops.decoder import greedy_decode as jgreedy
from lstm_ctc_ocr_torch.ops.decoder import greedy_decode


@pytest.mark.parametrize('seed,n,t,c', [(0, 5, 12, 7), (1, 16, 23, 64),
                                        (2, 9, 30, 3)])
def test_greedy_matches_jax(seed, n, t, c):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t, c) * 3).astype(np.float32)
    # runs of one class so that repeats and blanks between them occur
    logits[:, ::3, 1] += 6.0
    logits[:, 1::3, 1] += 6.0
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[-1] = 0, t
    want = np.asarray(jgreedy(jnp.asarray(logits), jnp.asarray(lens)))
    got = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_known_sequence():
    # frame argmax [2, 2, 0, 2, 1, 1, 0, 0] -> merge repeats, drop blanks
    path = [2, 2, 0, 2, 1, 1, 0, 0]
    logits = np.full((1, len(path), 4), -5.0, np.float32)
    logits[0, np.arange(len(path)), path] = 5.0
    out = greedy_decode(torch.from_numpy(logits), torch.tensor([8])).numpy()
    assert out[0].tolist() == [2, 2, 1, 0, 0, 0, 0, 0]
