"""The weight bridge between the JAX flat checkpoint keys and the port's
state_dict, on every tracked release: same key sets and shapes as the JAX
package restores, an exact round trip, and a model that loads every entry."""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint
from lstm_ctc_ocr_torch.models.factory import get_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASES = {'digit4': 'digit4.yml', 'lstm_ctc': 'lstm.yml',
            'lstm_records': 'records.yml', 'longline': 'longline.yml',
            'scene': 'scene.yml'}


def test_every_release_is_covered():
    shipped = sorted(os.listdir(os.path.join(REPO, 'checkpoints')))
    assert sorted(RELEASES) == [d for d in shipped if os.path.isdir(
        os.path.join(REPO, 'checkpoints', d))]


@pytest.mark.parametrize('exp', sorted(RELEASES))
def test_bridge_round_trip(exp):
    path, _ = checkpoint.latest_eval_checkpoint(
        os.path.join(REPO, 'output', exp))
    assert os.path.dirname(path) == os.path.join(REPO, 'checkpoints', exp)
    flat = checkpoint.read_flat(path)

    # the JAX package restores exactly these keys and shapes
    net = jget_network('LSTM_test')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (1, 64, 32), 'time_step_len': (1,)})
    template = jcheckpoint.flatten_state(
        {'params': params, 'bn_state': net.init_bn_state()})
    nclasses = flat['params/logits/biases'].shape[0]
    if nclasses == template['params/logits/biases'].shape[0]:
        assert {k: v.shape for k, v in template.items()} == \
            {k: v.shape for k, v in flat.items()}

    state = checkpoint.params_from_flat(flat)
    assert all(t.dtype == torch.float32 for t in state.values())
    assert state['conv1.kernel'].shape == (64, 1, 3, 3)
    assert state['conv5.kernel'].shape == (512, 512, 2, 2)
    assert state['logits.cells.fw.w'].shape == (512, 1024)
    assert state['logits.cells.fw.u'].shape == (256, 1024)
    np.testing.assert_array_equal(
        state['conv2.kernel'].numpy(),
        flat['params/conv2/kernel'].astype(np.float32).transpose(3, 2, 0, 1))

    back = checkpoint.flat_from_params(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype))
        assert back[k].astype(v.dtype).tobytes() == v.tobytes(), k

    cfg = load_cfg(os.path.join(REPO, 'lstm', RELEASES[exp]))
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, path, need_bn_state=True)
    sd = model.state_dict()
    assert sorted(sd) == sorted(state)
    for k, v in state.items():
        assert torch.equal(sd[k], v), k


def test_load_refuses_missing_bn_state_under_moving(tmp_path):
    flat = checkpoint.read_flat(glob.glob(os.path.join(
        REPO, 'checkpoints', 'lstm_ctc', '*.ckpt.npz'))[0])
    path = str(tmp_path / 'x_iter_1.ckpt.npz')
    np.savez(path, **{k: v for k, v in flat.items()
                      if not k.startswith('bn_state/')})
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'))
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, path, need_bn_state=False)
    with pytest.raises(RuntimeError, match='bn_state'):
        checkpoint.load_into(model, path, need_bn_state=True)
    del flat['params/conv3_1/kernel']
    np.savez(path, **flat)
    with pytest.raises(KeyError, match='conv3_1.kernel'):
        checkpoint.load_into(model, path, need_bn_state=False)
