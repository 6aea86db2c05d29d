"""The port's FCN segmentation helpers (``utils/segmentation.py``) against
the JAX package's on the same seeded numpy inputs.

The deterministic functions equal JAX's: one-hot labels, the valid mask and
the padded valid indices exactly, the masked cross entropy within 1e-6
relative (both in f32; the sums run in another order). The subsampler's
random draw comes from a ``torch.Generator`` and cannot give JAX's bits, so
it is held to JAX's caps and invariants instead of its indices: at most 500
foreground and 1000 pixels in all, the surplus disabled, other values
untouched, the identity under the caps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.utils import segmentation as jseg
from lstm_ctc_ocr_torch.utils import segmentation as seg

CLS = [0, 1, 2, 255]        # 3 real classes, 255 = mask-out


def _ann(seed, shape, values=(0, 1, 2, 255)):
    rng = np.random.RandomState(seed)
    return rng.choice(list(values), size=shape).astype(np.int32)


@pytest.mark.parametrize('shape', [(2, 2), (2, 6, 7), (3, 2, 4, 5)])
def test_labels_and_mask_equal_jax(shape):
    ann = _ann(0, shape)
    got = seg.labels_from_annotation(torch.from_numpy(ann), CLS).numpy()
    want = np.asarray(jseg.labels_from_annotation(jnp.asarray(ann), CLS))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        seg.labels_from_annotation_batch(torch.from_numpy(ann), CLS).numpy(),
        want)
    np.testing.assert_array_equal(
        seg.valid_mask(torch.from_numpy(ann), CLS).numpy(),
        np.asarray(jseg.valid_mask(jnp.asarray(ann), CLS)))


@pytest.mark.parametrize('size_of', ['all', 'half'])
def test_valid_entries_indices_equal_jax(size_of):
    """Padded to the static size, or cut to it: the same coordinates and
    the same count as the JAX ``jnp.where(size=...)`` form."""
    ann = _ann(1, (2, 4, 5))
    size = ann.size if size_of == 'all' else ann.size // 2
    idx, count = seg.valid_entries_indices(torch.from_numpy(ann), CLS, size)
    jidx, jcount = jseg.valid_entries_indices(jnp.asarray(ann), CLS, size)
    assert idx.dtype == torch.int32 and idx.shape == (size, 3)
    assert int(count) == int(jcount) == int((ann != 255).sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize('reduce', ['mean', 'sum'])
@pytest.mark.parametrize('seed', [2, 3])
def test_masked_cross_entropy_equals_jax(reduce, seed):
    ann = _ann(seed, (2, 6, 7))
    logits = np.random.RandomState(seed + 10).randn(2, 6, 7, 3) \
        .astype(np.float32) * 3
    got = float(seg.valid_softmax_cross_entropy(
        torch.from_numpy(ann), torch.from_numpy(logits), CLS, reduce=reduce))
    want = float(jseg.valid_softmax_cross_entropy(
        jnp.asarray(ann), jnp.asarray(logits), CLS, reduce=reduce))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_masked_cross_entropy_gradient_equals_jax():
    """Autograd through the mask: masked-out pixels get exactly zero, the
    rest JAX's gradient within 1e-6 of the largest."""
    ann = _ann(4, (1, 4, 4))
    logits = np.random.RandomState(5).randn(1, 4, 4, 3).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_()
    seg.valid_softmax_cross_entropy(torch.from_numpy(ann), x, CLS).backward()
    want = np.asarray(jax.grad(lambda lg: jseg.valid_softmax_cross_entropy(
        jnp.asarray(ann), lg, CLS))(jnp.asarray(logits)))
    got = x.grad.numpy()
    np.testing.assert_array_equal(got[ann == 255], 0.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _draw_invariants(ann, out, num_fg=500, num_total=1000):
    n_fg, n_bg = int((ann == 1).sum()), int((ann == 0).sum())
    keep_fg = min(n_fg, num_fg)
    keep_bg = min(n_bg, num_total - keep_fg)
    assert out.shape == ann.shape and out.dtype == ann.dtype
    assert int((out == 1).sum()) == keep_fg
    assert int((out == 0).sum()) == keep_bg
    others = (ann != 0) & (ann != 1)
    np.testing.assert_array_equal(out[others], ann[others])
    changed = out != ann
    assert set(np.unique(ann[changed]).tolist()) <= {0, 1}
    assert (out[changed] == 255).all()


@pytest.mark.parametrize('dtype', [np.int32, np.uint8])
@pytest.mark.parametrize('seed', [0, 1])
def test_subsample_holds_jax_caps(dtype, seed):
    """800 fg, 1500 bg, 100 other: both draws keep 500 + 500, disable the
    surplus and leave the rest; a uint8 mask keeps its caps (ranks do not
    wrap). Different generator seeds keep different pixels."""
    rng = np.random.RandomState(seed)
    ann = np.concatenate([np.ones(800), np.zeros(1500),
                          np.full(100, 7)]).astype(dtype)
    rng.shuffle(ann)
    ann = ann.reshape(40, 60)
    outs = []
    for g_seed in (seed, seed + 100):
        out = seg.subsample_fg_bg(torch.Generator().manual_seed(g_seed),
                                  torch.from_numpy(ann)).numpy()
        _draw_invariants(ann, out)
        outs.append(out)
    _draw_invariants(ann, np.asarray(jseg.subsample_fg_bg(
        jax.random.PRNGKey(seed), jnp.asarray(ann))))
    assert (outs[0] != outs[1]).any()


def test_subsample_under_caps_is_identity_as_in_jax():
    ann = np.concatenate([np.ones(100), np.zeros(200)]) \
        .astype(np.int32).reshape(10, 30)
    out = seg.subsample_fg_bg(torch.Generator().manual_seed(1),
                              torch.from_numpy(ann)).numpy()
    np.testing.assert_array_equal(out, ann)
    np.testing.assert_array_equal(out, np.asarray(jseg.subsample_fg_bg(
        jax.random.PRNGKey(1), jnp.asarray(ann))))


def test_get_valid_logits_and_labels_as_in_jax():
    """2,500 pixels of 0/1: 1,000 valid after the draw on both sides; the
    labels are the one-hot of the drawn annotation, the logits pass through."""
    ann = _ann(4, (50, 50), values=(0, 1))
    logits = np.random.RandomState(6).randn(50, 50, 3).astype(np.float32)
    labels, lg, mask = seg.get_valid_logits_and_labels(
        torch.Generator().manual_seed(2), torch.from_numpy(ann),
        torch.from_numpy(logits), CLS)
    jl, jlg, jmask = jseg.get_valid_logits_and_labels(
        jax.random.PRNGKey(2), jnp.asarray(ann), jnp.asarray(logits), CLS)
    assert labels.shape == tuple(jl.shape) == (50, 50, 3)
    np.testing.assert_array_equal(lg.numpy(), np.asarray(jlg))
    assert int(mask.sum()) == int(np.asarray(jmask).sum()) == 1000
    # a valid pixel's label is one-hot, a disabled pixel's is all zero
    np.testing.assert_array_equal(labels.sum(-1).numpy(),
                                  mask.numpy().astype(np.float32))
