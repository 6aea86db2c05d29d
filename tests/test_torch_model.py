"""The port's CRNN forward against the JAX package's, on release weights.

The ``lstm_ctc`` release is loaded through both packages (the port through
its weight bridge) and one preprocessed batch of 8 tracked val images at the
W=96 bucket goes through both, in f32. Tolerance: max |logit difference|
<= 2e-4 with logits up to ~25 in size. The two run the same arithmetic,
but the CPU convolutions (oneDNN for the port, XLA for JAX) sum in another
order through seven convs, two batch norms and the recurrence; measured
difference is ~3e-5. Greedy ids must agree exactly.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.engine.test import prepare_single as jprepare
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_tpu.ops.decoder import greedy_decode as jgreedy
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data.image import load_image
from lstm_ctc_ocr_torch.engine import checkpoint
from lstm_ctc_ocr_torch.engine.test import prepare_single
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.ops.decoder import greedy_decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'checkpoints', 'lstm_ctc',
                    'lstm_ctc_iter_32207.ckpt.npz')


@pytest.fixture(scope='module')
def batch():
    """[8, 96, 32] f32 images and their time steps, via the port's loader;
    the JAX preprocessing (OpenCV) must give the same array."""
    cv2 = pytest.importorskip('cv2')
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'))
    imgs, steps = [], []
    for f in sorted(glob.glob(os.path.join(REPO, 'data', 'val', '*.png'))):
        im, ts = prepare_single(load_image(f), cfg)
        if im.shape[1] != 96:
            continue
        jim, jts = jprepare(cv2.imread(f, 0))
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(ts, jts)
        imgs.append(im[0])
        steps.append(ts[0])
        if len(imgs) == 8:
            break
    return np.stack(imgs), np.array(steps, np.int32)


@pytest.fixture(scope='module')
def jax_model():
    net = jget_network('LSTM_test')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (1, 64, 32), 'time_step_len': (1,)})
    state = jcheckpoint.restore(
        {'params': params, 'bn_state': net.init_bn_state()}, CKPT)
    return net, state


@pytest.mark.parametrize('bn_eval', ['batch', 'moving'])
def test_release_logits_match_jax(batch, jax_model, bn_eval):
    x, lens = batch
    net, state = jax_model
    moving = bn_eval == 'moving'
    want = np.asarray(net.apply(
        state['params'], {'data': jnp.asarray(x),
                          'time_step_len': jnp.asarray(lens)},
        dtype=None, bn_stats=state['bn_state'] if moving else None)['logits'])

    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'))
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, CKPT, need_bn_state=moving)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(lens),
                           moving_bn=moving)
    assert got.dtype == torch.float32 and got.shape == want.shape == (23, 8, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)

    ids = greedy_decode(got.transpose(0, 1), torch.from_numpy(lens)).numpy()
    jids = np.asarray(jgreedy(jnp.swapaxes(jnp.asarray(want), 0, 1),
                              jnp.asarray(lens)))
    np.testing.assert_array_equal(ids, jids)


def test_uint8_input_is_divided_by_255(batch):
    """Raw uint8 pixels give the same logits as host-side /255 floats."""
    x, lens = batch
    raw = np.rint(x * 255.0).astype(np.uint8)
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'))
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, CKPT, need_bn_state=False)
    with torch.inference_mode():
        a = model(torch.from_numpy(raw), torch.from_numpy(lens))
        b = model(torch.from_numpy(raw.astype(np.float32) / 255.0),
                  torch.from_numpy(lens))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
